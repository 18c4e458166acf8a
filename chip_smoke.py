#!/usr/bin/env python3
"""Smoke run of the PyTorch port (relation_detr_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, one line each; any failure raises and the exit code is non-zero:
  1. device: nvidia-smi name and power limit, torch/CUDA/nvcc versions, and
     which JPEG decoders the machine has (nvjpeg.h with libnvjpeg.so,
     jpeglib.h with libjpeg.so; informational, never fails);
  2. build: nvcc builds the CUDA kernels and the nvJPEG decoder from csrc/
     (two libraries, every source's nvcc started at once; seconds printed);
  3. kernels against their plain PyTorch versions on the card, TF32 off, at
     the flagship's shapes, with CUDA-event times of both (and of one
     PyTorch call computing the same function, where there is one) and the
     least time the card could take (bound): msda_fwd and msda_bwd at the
     encoder shape (Q=S=22,323) and the decoder shapes Q=300, 500, 600
     (the model families' 300 queries, with 200 CDN slots, with 300 DN
     slots), 900, 1100 and 1500, each on the encoder-like and the
     scattered location sets, and at the encoder shape of the 1216x2016
     canvas (FocalNet-L's 1200x2000 config: Q=S=50,882, levels 152x252,
     76x126, 38x63, 19x32) on both sets, relation_bias_v4_fwd (N=300,
     500, 600, 900 and 1100, with bounds) and the relation bias's backward
     (N=1100), window_accumulate at the four levels' window grids
     (bit-identical, one covering-window table build per level, at
     the first call), the tiled encoder MSDA's tiled_core_fwd,
     tiled_core_bwd and sep_contract_fwd on its operands at the four levels
     (B=1, and level 0 at B=2; tiled_core_fwd also on edge entries: rows
     negative or >= M and NaN weights on them, which add nothing, and a NaN
     weight on a row inside, which gives NaN; tiled_core_bwd on adversarial
     entries, and two launches bit-identical; sep_contract_fwd beside the
     3-operand torch.einsum), each with its bound, and
     relation_bias_rel_fwd (N=900 and 1100, rel from boxes with a NaN and an
     Inf centre; at N=900 also |rel| up to 90 and a NaN and an Inf rel, the
     same NaN pattern as the plain version); and the evaluation path's
     shapes: msda_fwd at B=2 (Q = S and 900) on the levels of every canvas
     the eval CLI batches the committed split into (from the loader's
     batches and the annotated sizes) and of the portrait bucket (1344,
     800), and relation_bias_v4_fwd at B=2, N=900; and the JPEG decoder's
     ycc_to_rgb (libjpeg-turbo's chroma upsampling and colour conversion)
     on nvJPEG's planes of the split's largest file, bit-identical, through
     the wrapper the decoder calls; and the bf16-value forms msda_fwd_bf16
     and msda_bwd_bf16 at the MSDA shapes and sets, each bf16 result
     within one bf16 rounding of the fp32 sums (the error in bf16 units of
     the max), the fp32 gradients at TOL_BWD_REL, timed beside their plain
     versions and the fp32 forms with bounds at 2 bytes a value element,
     and a NaN location;
  4. in-model parity: the tiny-test config on the GPU (kernels) and on the
     CPU (plain versions), same weights and inputs: the eval forward, then
     one train forward + backward with the same CDN draws, run on the CPU
     twice: as is, and sampling at the GPU's MSDA locations; under the
     gather, impl="tiled", impl="tiled_xla" with tiled_sep_kernel, and the
     gather under relation version 1 (the card's relation_bias_rel_fwd
     against its plain version on the CPU, which takes the v4 math's
     otherwise); then under the bf16 policy (compute_dtype =
     backbone_dtype = bf16): the encoder's class logits before the top-k
     in bf16 units; on the GPU's top-k (``PinnedTopk``) the heads in bf16
     units and the train loss terms (total at 1%, each term at 5% or
     1e-3); every gradient fp32 and finite; the unpinned heads' numbers in
     tests/test_model_families.py's bf16 class printed;
  5. the flagship config (ResNet-50, embed 256, 6+6 layers, 900 queries,
     91 classes, fp32, seeded random weights) answers 4 requests on the
     800x1344 canvas through ``inference.detect``, each going through 12
     MSDA and 5 relation-bias kernel launches; then the B=1 p50 latency (15
     detects) and peak device memory; then the same weights on the
     full-canvas request under impl="tiled", under "tiled_xla" +
     tiled_sep_kernel and under relation versions 1 and 2: pre-top-k heads
     against the default's, launches per forward, p50 and peak memory of
     each; then the same weights under the bf16 policy: 12 msda_fwd_bf16
     and 5 relation_bias_v4_fwd launches, on the fp32 detect's top-k the
     heads in tests/test_model_families.py's bf16 class against fp32's, p50
     (with its range) and peak memory beside fp32's;
  6. the flagship train step (``parallel.train_step.make_train_step``: CDN,
     hybrid branch, matcher, criterion, backward, clip, AdamW) on synthetic
     batches in the loader's layout: B=1 at GT capacity 100 (2 warm-up + 15
     timed steps) and 16 (2 + 5), B=2 at 100 (3 steps), then B=1 at 100
     under impl="tiled" (1 + 8 steps, no covering-window table built);
     p50 step time, peak memory, kernel launches and host matching
     seconds per step; then under the bf16 policy at B=1 GT 100 and B=2
     with remat unset, "none", "dots" and "save_all" (a model each): p50
     and range, peak memory, launches per step, every gradient fp32 and
     finite;
  7. the COCO evaluation path on the committed synthetic val split
     (tests/data/torch_port/): (a) nvJPEG decodes the fixtures (4:4:4,
     4:2:0, grayscale, EXIF Orientation 6, 4:2:2, 4:4:0, 4:1:1, Adobe CMYK
     and YCCK) against cv2's decodes, shapes exact and mean |difference|
     within TOL_DECODE_MEAN (max, mean and the share more than 8 levels off
     printed), and the split's 8 JPEGs at their annotated sizes; (b)
     ``relation_detr_tpu_torch.test`` on the flagship config (seeded
     weights, B=2) over the split, twice: every canvas one that phase 3
     held msda_fwd on, 12 msda_fwd and 5
     relation_bias_v4_fwd launches per batch and one ycc_to_rgb per image,
     300 finite detections per image, stats equal to the --eval-json
     re-score of its own results JSON; (c) the same CLI over the split
     EVAL_CYCLES times (new image ids): images/s and ms per image by stage
     (decode, host transform, pinning, copy to the card, forward,
     evaluator) over hundreds of images; (d) a control with nonzero AP:
     the split's jittered ground truth as the detections through the
     CLI's ``evaluate``, AP50 1 and AP above 0.5, equal to the --eval-json
     re-score; (e) the tiny-test config over the split's card-decoded
     batches through ``make_detections_fn`` on the GPU (kernels) and the
     CPU (plain versions): normalised canvases bit-identical, pre-top-k
     heads at TOL_MODEL;
  8. the train CLI (``relation_detr_tpu_torch.train``): (a) the flagship
     config at full width, seeded weights, over the committed synthetic
     train split (16 JPEGs, nvJPEG, the detr preset) at B=2 on the
     800x1344 canvas, 2 micro-steps an update, EMA 0.9998, 2 epochs (16
     steps, 8 updates) with an evaluation each over the val split: 18
     msda_fwd, 18 msda_bwd and 5 relation_bias_v4_fwd launches a step (12
     and 5 an evaluated image) and one ycc_to_rgb an image read, every loss
     finite, each update's lr the schedule's, checkpoints of epochs 0 and 1
     beside latest.npz, latest_ema.npz and best_ap.npz, latest.npz loading
     into a fresh model with nothing missing or mismatched and equal to the
     checkpoint, the EMA neither the initial nor the latest weights; (b) the
     CLI's restore into a fresh model, AdamW, train step and EMA,
     bit-identical to the checkpoint, then --resume trains epoch 2 only; (c)
     the tiny config overfits 4 images on the card (loss at most 0.55x, AP50
     at least 0.5); (d) run (a)'s step p50 and range, images/s, the main
     thread's wait for the next batch, the pinning and upload spans, peak
     memory and the host's load average, past its first 2 steps; (e) one
     epoch with --mixed-precision bf16 --remat-policy dots (36 msda_fwd,
     18 msda_bwd a step, all bf16-value forms), the restore into a fresh
     bf16 model bit-identical, a --resume for a second epoch;
  9. the model families (``FAMILY_CONFIGS``: DINO++, Deformable-DETR++,
     DN-Def-DETR++, DAB-Def-DETR++) and SA-Det: (a) each family config at
     full width (ResNet-50, its own queries, seeded weights, fp32) answers
     4 requests on the 800x1344 canvas through ``inference.detect`` (12
     msda_fwd and 5 relation_bias_v4_fwd launches each, the relation bias
     at the family's N; p50, range and peak memory) and takes train steps
     at B=1, GT capacity 100 (1 warm-up + 3 timed; 12 msda_fwd, 12
     msda_bwd and 5 relation_bias_v4_fwd a step; every loss term and the
     gradient norm finite; p50 and peak memory); (b) the SA-Det config
     (2 classes) one detect and one train step with every label 1; (c)
     each family at a tiny size (ResNet-18, 1 + 2 layers, 30 queries), GPU
     (kernels) against CPU (plain versions): the eval heads (and the
     encoder's top-k) at TOL_MODEL, one train forward + backward with the
     same denoising draws as phase 4 holds it, also with ``PinnedKinks``;
     (d) the train CLI on the DINO++ config for one epoch over the
     committed train split at B=2 with its evaluation, and the eval CLI on
     the DN-Def-DETR++ config (single-stage: no encoder outputs) over the
     val split at B=2, launches counted, metrics finite;
 11. (run before phase 10) the models with large backbones: (a) a tiny
     form of each backbone family (Swin v1 and v2, ConvNeXt, FocalNet with
     every flag on) on the tiny-test config, GPU (kernels) against CPU
     (plain versions), same weights: the encoder's heads before the
     two-stage top-k and the
     decoder's heads at TOL_MODEL, one train forward + backward as phase
     9 (c) holds a family (the backbone's weights offset too); (b) the
     four large configs (``LARGE_CONFIGS``: Swin-L, ConvNeXt-L and
     FocalNet-L on the 800x1344 canvas, FocalNet-L's 1200x2000 config on
     the 1216x2016 canvas with EvalPreset(1200, 2000) images) at full
     width, uncut, seeded weights, fp32: 4 requests through
     ``inference.detect`` (12 msda_fwd and 5 relation_bias_v4_fwd
     launches each), the p50 and range, peak memory, the time by stage
     (backbone, neck, encoder, two-stage, decoder; CUDA events in forward
     hooks), then 1 + 3 train steps at B=1, GT capacity 100 (18 msda_fwd,
     18 msda_bwd, 5 relation_bias_v4_fwd a step; losses and gradient norm
     finite), p50 and peak memory; and one Swin-L detect under the bf16
     policy, whose backbone outputs must be fp32 and the fp32 run's bit
     for bit;
 12. (run before phase 10) ViT, EVA-02 and the DCN ResNet: (a) a tiny ViT,
     a tiny EVA-02 (RoPE, SwiGLU, windows that pad) and the DCN ResNet-18
     (offsets and masks perturbed: samples fractional, some off the map)
     on the tiny-test config, GPU against CPU as phase 11 (a) holds them
     (the DCN's sampling points pinned too); (b) the flagship config on
     ``VIT_DCN_MODELS`` (ViT-B, ViT-L, EVA-02-B, EVA-02-L, ResNet-50 with
     DCN in layer2-4) at full width as phase 11 (b) runs its configs,
     every gradient of a step finite and the DCN offsets' non-zero (the
     R50-DCN: 13 bilinear_sample_fwd launches a detect, 13 and 13
     bilinear_sample_bwd a train step); one
     R50-DCN detect under the bf16 policy (every DCN fed and computing in
     fp32, the other convs in bf16) and one EVA-02-L detect (backbone
     outputs the fp32 run's bit for bit); (c) the DCN sampler's kernels
     (csrc/grid_sample.cu: bilinear_sample_fwd and bilinear_sample_bwd)
     against their plain versions at the R50-DCN's conv2 shapes and at a
     wide layer2.0 case (offsets N(0, 8), far-off, saturating and NaN
     points), output and both gradients, timed in turns with them and
     beside ``F.grid_sample``, the bounds and the first kernels' times,
     and their share of the DCN detect and step (each shape's device ms a
     launch from torch.profiler in phase 10); and ``nms_mask`` (plain
     PyTorch) at N=300, B=1 and 2, on
     the flagship's detect outputs through
     ``post_process(nms_iou_threshold=0.7)``, its keep mask the CPU's
     exactly;
 13. (run after phase 10, the flagship model freed) data parallelism on
     the flagship (``parallel/mesh.py``, seeded weights, 800x1344): (a) in
     this process, a NCCL group of one process against no group: an eval
     batch bit-identical, two train steps (the first's losses
     bit-identical, then within msda_bwd's atomics noise); (b) the
     one-process B=2 step, its two-stage top-k recorded, then timed, and
     the eval CLI at B=2 over the committed split; (c) 2 spawned processes
     (``dp_process``; NCCL on 2 cards where the machine has 2, else gloo
     with both on card 0, printed): the step at B=1 a process on (b)'s
     images, denoising draws and top-k against (b)'s step (losses,
     grad_norm, the parameters after the update, both processes'
     parameters equal), launches per step, timed steps and the gradient
     all-reduce's span and bytes; the train CLI for an epoch of the
     16-image split at B=1 with an evaluation (rank 0 writes one
     checkpoint; the same stats in both) and a --resume of it; the eval
     CLI at B=2, whose 12 stats equal (b)'s in both processes; a process
     that fails, or a collective that waits past DP_TIMEOUT_S, fails the
     phase;
 14. (after phase 13) the rest of the host data path: (a) the numpy
     counterparts of cv2 (``data/cv_ops.py``: HSV both ways, grey, box and
     median blur, the Gaussian blur, shifts, nearest resize, fillPoly on
     400 polygon masks, the JPEG round trip at quality 85, 90 and 95) and the PNG
     decode (every PNG fixture, the Adam7 files of every colour type and
     depth and the eXIf-oriented ones among them) on this machine's numpy
     against cv2's outputs committed by
     tests/data/torch_port/make_fixtures.py, equal bytes; a broken JPEG
     raises UnreadableImage through nvJPEG; (b) every registered train
     preset through the loader (4 threads, nvJPEG) over the committed train
     split: wall, decode and transform ms an image; (c) the train CLI on
     the flagship at full width, B=2, one epoch of 8 steps under
     strong_album, mosaic_detr followed by the mask SimpleCopyPaste (the
     split's segmentations, return_masks) and lsj on a 1024x1024 canvas,
     each through a train config of its own: step p50 and range, the main
     thread's wait for the next batch, peak memory, launches a step;
 15. the tools (run after 14): (a) the flagship fp32 (seeded weights,
     B=1, 800x1344) through ``tools.export_model --verify`` (export, save
     and load seconds, the round trip through the disk at rtol 1e-3 /
     atol 1e-5 with labels equal, the exported detect's launches: 12
     msda_fwd and 5 relation_bias_v4_fwd, and its p50 against the eager
     detect's over 20 CUDA-event runs); (b) the tiny config exported and
     verified under impl="tiled", "tiled_xla" with the separable kernel
     and relation version 1, each exported detect launching its form's
     kernel; (c) ``tools.benchmark_model`` on the flagship (parameters,
     FLOPs with the ops' share, p50 / p90, queued rate); (d) host
     microseconds a call of each ``torch.library`` op against the direct
     ctypes launch and the wrapper (each kernel row's op_route_host_us);
     (e) both CLIs' ``--show-dir`` (the eval CLI over the committed split,
     the folder CLI with a weight file holding ``_classes_``), each written
     JPEG the drawing's ``encode_jpeg`` and decoded back on the card
     within phase 7's bar (mean 0.25 levels) of ``cv_ops.jpeg_roundtrip``;
     its seconds printed;
 16. (after phase 12, before 10) the JAX package's tiled MSDA settings and
     the clamp gate: (a) tiled_core_fwd, tiled_core_bwd (two launches
     bit-identical) and sep_contract_fwd on the operands msda_tiled builds
     at every geometry of SETTINGS_GRID (tile tokens (10, 8), (12, 8),
     (12, 10), (14, 8), (16, 8) and (24, 8) at auto halos and margin 1;
     margin 2; halos (4, 3, 2, 2), (0, 0, 0, 0) and (8, 8, 8, 8)) on the
     800x1344 and 1216x2016 canvases at B=1 and 2, against their plain
     versions at every level, level 0 timed in turns with them beside its
     bound (each kernel row's ``settings_grid``); (b) the flagship detect
     under each of SETTING_GROUPS (fast halos + overflow 0, halos 2 +
     overflow 8, tile (24, 8), t_major, slab xy and bm, patch gather, B=2
     batch unroll, bf16 slab + dot through the separable kernel, int8
     slab) against the gather's: pre-top-k heads (exact groups at
     TOL_TILED_EVAL, bf16 at TOL_BF16_UNITS, the rest printed), the
     encoder's corners off their patch and past the overflow capacity, the
     p50 of SETTINGS_DETECTS detects, launches a detect; (c) one flagship
     train forward + backward under impl="tiled" at tile (16, 8) (the
     one-stage tiled_core_bwd) against the gather's with the kinks and
     top-k pinned, 24 launches of each tiled kernel; (d) the eval CLI over
     the split with the seeded weights as an .npz under --msda-impl tiled,
     with --clamp-check on and with --msda-profile fast: the per-layer
     clamp fraction and the profile;
 10. torch.profiler, after every timed phase (so that no profiler session
     runs before a p50): the MSDA kernels' device time per launch at each
     phase-3 shape and set, relation_bias_v4_fwd's at N=300, 500, 600,
     900 and 1100 and relation_bias_rel_fwd's at N=900 and 1100, tiled_core_fwd's at the four
     levels and B=2 level 0, the MSDA and relation kernels' device time in
     one default train step and one flagship detect (with its host-to-device
     copies), sep_contract_fwd's in one sep-kernel eval forward,
     tiled_core_fwd's in one impl="tiled" detect and
     relation_bias_rel_fwd's in one relation-version-1 detect (each row's
     device_ms and in_model_eval: [ms, launches] per kernel name); then 5
     calls of the flagship decoder's relation module, whose only device
     work must be one relation_bias_v4_fwd launch a call; one B=2 eval
     forward's span on the stream against its device-busy time (the idle
     share of phase 7's "forward" stage); one train CLI step's (the CLI's
     --profile-steps) device-busy time against its span; the precision
     profiles (``profile_precision``) of one fp32 and one bf16 detect and
     one bf16 train step: device time in bf16 and fp32 GEMMs and
     convolutions, casts, the port's kernels and the rest, by the
     launching operator's input dtypes, and the idle share; then a JSON
     kernel table, one row per kernel (launches: from the run of the
     path that takes it, each counter set to 0 just before that run:
     msda_fwd, msda_bwd and relation_bias_v4_fwd from the default train
     step, tiled_core_fwd/bwd and window_accumulate from the tiled train
     step, sep_contract_fwd from the sep-kernel eval, relation_bias_rel_fwd
     from the version-1 and version-2 evals; bilinear_sample_fwd and
     bilinear_sample_bwd from phase 12 (b)'s R50-DCN train steps (their
     eval_launches from its detects, their times summed over a forward's
     13 DCN shapes); ycc_to_rgb, and
     eval_cli_launches of msda_fwd and relation_bias_v4_fwd, from phase
     7 (b)'s second CLI run; train_cli_launches of msda_fwd, msda_bwd,
     relation_bias_v4_fwd and ycc_to_rgb from phase 8 (a); msda_fwd_bf16
     and msda_bwd_bf16 from the bf16 train step with remat unset;
     family_launches of msda_fwd, msda_bwd and relation_bias_v4_fwd from
     each of phase 9's paths; large_backbone_launches from each of phase
     11's; vit_dcn_launches from each of phase 12's; dp_launches, each
     process's, from phase 13's steps; data_path_launches of msda_fwd,
     msda_bwd, relation_bias_v4_fwd and ycc_to_rgb from each of phase 14
     (c)'s runs; op_route_host_us from phase 15 (d); settings_grid of the
     three tiled kernels from phase 16 (a)), after JSON lines of the
     precision profiles and phase 7's, 8's, 9's, 11's, 12's, 13's, 14's,
     15's and 16's results,
     then the last line
     {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.

Bounds: bytes are each input read once and each output written once;
operations count one per sin/cos and two per FMA, as each row's comment
says.

Imports neither jax, flax, cv2, PIL, matplotlib nor the JAX package. Exits non-zero,
printing no result, without a CUDA device or outside a checkout of the
repository.
"""
from __future__ import annotations

import copy
import gc
import importlib
import json
import math
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
CANVAS = (800, 1344)
LEVELS = ((100, 168), (50, 84), (25, 42), (13, 21))  # the canvas' 4 levels
# FocalNet-L's 1200x2000 config: an EvalPreset(1200, 2000) image on this
# canvas feeds the encoder MSDA 50,882 tokens (phases 3 and 11)
LARGE_CANVAS = (1216, 2016)
REQUESTS = ((800, 1333), (800, 1066), (600, 1344), (800, 1344))  # valid (h, w)
CONFIGS = "relation_detr_tpu_torch.configs.relation_detr."
TOL_KERNEL = 1e-4
TOL_MODEL = 2e-3
# backward kernels: max |kernel - plain| / max |plain| per gradient (fp32
# atomics and other reduction orders than autograd's)
TOL_BWD_REL = 1e-4
# tiny train step GPU vs CPU: every loss term (relative) and every
# parameter's gradient (of the leaf's max |grad|), as the CPU tests hold the
# port against JAX. GPU and CPU round convolutions and GEMMs differently, so
# an input that sits within that rounding of a kink (a ReLU input near 0, an
# MSDA sample near a pixel boundary) takes the other side on each device,
# and its gradient jumps. One ReLU input of layer3.0.conv1 that is 8e-6
# from 0 moves layer2's output gradient on a 3x3 patch by up to 1.2e-2 of
# its max (measured on the H100), so backbone leaves are held with the
# CPU's kinks pinned to the GPU's side (``PinnedKinks``); every other leaf
# is held on the unpinned run too.
TOL_TRAIN_LOSS = 1e-4
TOL_TRAIN_GRAD = 1e-3
TRAIN_RUNS = ((1, 100, 2, 15), (1, 16, 2, 5), (2, 100, 0, 3))  # B, GT cap, warm-up, timed
# the model families' decoder widths, where phase 3 holds msda_fwd / msda_bwd
# (Q) and relation_bias_v4_fwd (N): 300 queries, + 200 CDN slots, + 5 x 60
# DN slots (DINO++ itself runs 900 / 1100, the flagship's)
FAMILY_N = (300, 500, 600)
TILED_TRAIN_RUN = (1, 100, 1, 8)
DETECT_RUNS = 15  # timed default detects (the p50 of the eval path)
# phase 4's forms: msda_defaults settings and relation bias version (None:
# the default, 4)
TINY_VARIANTS = (("gather", {}, None), ("tiled", dict(impl="tiled"), None),
                 ("tiled_xla + tiled_sep_kernel", dict(impl="tiled_xla", tiled_sep_kernel=True),
                  None),
                 ("gather + relation v1", {}, 1),
                 # the tiny canvas' patches are smaller than its levels at
                 # halo 0, so the overflow channel engages
                 ("tiled + halos 0 + overflow 8",
                  dict(impl="tiled", tiled_halos=(0, 0, 0, 0), tiled_overflow=8), None),
                 ("tiled_xla + t_major", dict(impl="tiled_xla", tiled_layout="t_major"), None))
BOXES_PER_IMAGE = 7
# the tiled forms' contraction kernels against their plain versions: the
# forwards sum in another order than the dense one-hot product (1e-5 abs);
# tiled_core_bwd sums each dpatch row's entries and dw's channels in its own
# fixed order (TOL_BWD_REL of each max)
TOL_TILED = 1e-5
# flagship eval, tiled vs gather: exact up to summation order inside the
# auto halos (all samples at the seeded init on the full canvas)
TOL_TILED_EVAL = 1e-4
# one NVIDIA H100 SXM: HBM bytes/s and fp32 (non-tensor-core) FLOP/s, the
# published peaks the bound_ms of every kernel row divides by
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
BF16_EPS = 2.0 ** -8  # bf16's unit roundoff
# the phase-5 variants beside the default (gather MSDA, relation v4)
EVAL_VARIANTS = (
    ("tiled", dict(impl="tiled"), None, TOL_TILED_EVAL),
    ("tiled_xla + tiled_sep_kernel", dict(impl="tiled_xla", tiled_sep_kernel=True), None,
     TOL_TILED_EVAL),
    # v1/v2 take the direct relation (no separable regrouping): the bias
    # moves by ~1e-4, so the heads are held at the GPU-vs-CPU tolerance
    ("relation v1", {}, 1, TOL_MODEL),
    ("relation v2", {}, 2, TOL_MODEL),
)


# phase 7, the COCO evaluation path: the committed synthetic val split
# (tests/make_synth_coco.py's, 8 JPEGs) and the decode fixtures
# (tests/data/torch_port/make_fixtures.py) with cv2's decodes as .npy
EVAL_DATA = os.path.join("tests", "data", "torch_port")
EVAL_BATCH = 2
# the portrait bucket, which real COCO batches reach and the committed split
# does not: phase 3 holds msda_fwd at B=2 on its levels beside those of
# every canvas the eval CLI batches the split into (``eval_canvases``)
PORTRAIT_CANVAS = (1344, 800)
# phase 7's throughput run: the split's 8 images this many times over
EVAL_CYCLES = 50
# the decode fixtures and the mean |nvJPEG - cv2| in levels each may have,
# at most. With libjpeg-turbo's chroma upsampling and colour conversion
# (ycc_to_rgb) only the inverse DCT's rounding differs: 0.02-0.05 on the
# H100, against 4.78 at 4:2:0 with nvJPEG's own RGB output (saturated
# rectangles on noise, the synthetic split's worst case)
DECODE_FIXTURES = ("decode_444", "decode_gray", "decode_420", "decode_exif6", "decode_422",
                   "decode_440", "decode_411", "decode_cmyk", "decode_ycck")
TOL_DECODE_MEAN = 0.25
STATS = ("AP", "AP50", "AP75", "APs", "APm", "APl", "AR1", "AR10", "AR100", "ARs", "ARm", "ARl")


def phase(n, msg):
    print(f"[phase {n}] {msg}", flush=True)


def _run(cmd):
    return subprocess.run(cmd, capture_output=True, text=True, check=True).stdout.strip()


def cuda_ms(fn, iters, warmup=2):
    """Mean milliseconds per call from CUDA events around ``iters`` calls."""
    import torch

    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def in_turns(plain, kernel, iters_plain, iters_kernel, library=None):
    """Times as plain, kernel, library, library, kernel, plain; mean of each
    pair. Returns (kernel ms, plain ms), or with ``library`` (one PyTorch
    call computing the same function) (kernel ms, plain ms, library ms)."""
    p1 = cuda_ms(plain, iters_plain)
    k1 = cuda_ms(kernel, iters_kernel)
    lib = None
    if library is not None:
        lib = (cuda_ms(library, iters_plain) + cuda_ms(library, iters_plain)) / 2
    k2 = cuda_ms(kernel, iters_kernel)
    p2 = cuda_ms(plain, iters_plain)
    times = ((k1 + k2) / 2, (p1 + p2) / 2)
    return times if library is None else (*times, lib)


def bound(nbytes, ops):
    """(bound_ms, bound_by): the least time one H100 could take to move
    ``nbytes`` through HBM and do ``ops`` fp32 operations, the larger of
    the two."""
    by_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    by_ops = ops / FP32_OPS_PER_S * 1e3
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops, "operations")


def size(*tensors):
    return sum(t.numel() * t.element_size() for t in tensors)


def msda_value_bytes(torch, value, levels, locs):
    """The bytes of ``value`` (B, S, H, D) that a gather MSDA at ``locs``
    (B, Q, H, L, P, 2) must read: each (image, token, head) row of D
    elements that an in-range corner of a sample touches, read once. Where
    samples overlap or the queries are few this is less than the whole
    value (``size(value)``)."""
    bs, total, heads, _ = value.shape
    row_bytes = value.shape[3] * value.element_size()
    touched = torch.zeros(bs * total * heads, dtype=torch.bool, device=value.device)
    img = torch.arange(bs, device=value.device).view(bs, 1, 1, 1)
    head = torch.arange(heads, device=value.device).view(1, 1, heads, 1)
    start = 0
    for lvl, (h, w) in enumerate(levels):
        loc = locs[:, :, :, lvl].float()  # (B, Q, H, P, 2)
        x0 = torch.floor(loc[..., 0] * w - 0.5)
        y0 = torch.floor(loc[..., 1] * h - 0.5)
        for dy in (0, 1):
            for dx in (0, 1):
                x, y = x0 + dx, y0 + dy
                ok = (x >= 0) & (x < w) & (y >= 0) & (y < h)  # NaN and Inf fail
                tok = start + torch.where(ok, y * w + x, 0).long()
                touched[((img * total + tok) * heads + head)[ok]] = True
        start += h * w
    return int(touched.sum().item()) * row_bytes


def profile_kernels(torch, fn, names):
    """Device time of the kernels in one run of fn, from torch.profiler's
    key_averages(): {kernel name: [ms, launches]} for every kernel whose
    name contains one of names (each template instance on its own line),
    or None when the profiler saw no device time at all."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    found, busy = {}, 0.0
    for evt in prof.key_averages():
        us = evt.self_device_time_total
        busy += us
        if any(n in evt.key for n in names) and us > 0:
            found[evt.key] = [us / 1e3, evt.count]
    return found if busy > 0 else None


# (label, fn, kernel names, row, key): torch.profiler runs of fn, made in
# phase 10 after every timed phase, so that no profiler session precedes a
# p50; each stores {kernel: [ms, launches]} (or None) at row[key]
PROFILES = []


def run_profiles(torch):
    """Prints and stores the device time of the named kernels in one run of
    each of PROFILES' fns (``profile_kernels``)."""
    for label, fn, names, row, key in PROFILES:
        # a session now and then sees no device activity at all: take a second
        found = profile_kernels(torch, fn, names) or profile_kernels(torch, fn, names)
        row[key] = found
        if found is None:
            phase(10, f"{label}: torch.profiler saw no device time")
            continue
        phase(10, f"{label}: device time (torch.profiler key_averages()): " +
              "; ".join(f"{k} {v[0]:.4f} ms over {v[1]} launches" for k, v in found.items()))


def msda_inputs(torch, gen, num_queries, dev, levels=LEVELS):
    """The scattered set, the worst case for locality and the correctness
    set: locations uniform over the image (point 0) or over the image and a
    margin past it (points 1-3), whatever the query; every 7th query
    with point 1 on the left and top borders, every 11th with point 2 on
    the right and bottom ones, every 5th with point 3 on pixel centres of
    random tokens plus whole-pixel offsets."""
    total = sum(h * w for h, w in levels)
    h_, l_, p_, d_ = 8, len(levels), 4, 32
    value = torch.randn(1, total, h_, d_, generator=gen, device=dev)
    locs = torch.rand(1, num_queries, h_, l_, p_, 2, generator=gen, device=dev) * 1.2 - 0.1
    locs[:, :, :, :, 0] = torch.rand(1, num_queries, h_, l_, 2, generator=gen, device=dev)
    locs[:, ::7, :, :, 1] = 0.0
    locs[:, ::11, :, :, 2] = 1.0
    on_pixel_centres(torch, gen, locs[:, ::5, :, :, 3], levels)
    attn = torch.rand(1, num_queries, h_, l_, p_, generator=gen, device=dev)
    attn = attn / attn.sum(dim=(-2, -1), keepdim=True)
    return value, locs.contiguous(), attn.contiguous()


def msda_encoder_inputs(torch, gen, num_queries, dev, levels=LEVELS, batch=1):
    """The encoder-like set: each query is a token sampling near its own
    reference point at every level, the cell centre at valid ratio 1
    (``models/base_transformer.py::get_full_reference_points``), plus the
    radial offset initialisation (``models/attention.py::
    sampling_offsets_bias``) and N(0, 1.5 px) jitter, both in each level's
    pixels, as ``models/attention.py`` divides offsets by the level's size.
    Every 97th query samples point 3 anywhere over the image and a margin
    past it (far outside its tile), every 89th point 0 past a border. At
    Q = S the queries are the tokens in order (the encoder); otherwise Q
    tokens in random order (a decoder's queries have no spatial order)."""
    from relation_detr_tpu_torch.models.attention import sampling_offsets_bias

    total = sum(h * w for h, w in levels)
    h_, l_, p_, d_ = 8, len(levels), 4, 32
    value = torch.randn(batch, total, h_, d_, generator=gen, device=dev)
    refs = torch.cat([torch.stack(torch.meshgrid((torch.arange(w, device=dev) + 0.5) / w,
                                                 (torch.arange(h, device=dev) + 0.5) / h,
                                                 indexing="xy"), -1).reshape(-1, 2)
                      for h, w in levels])
    if num_queries != total:
        refs = refs[torch.randperm(total, generator=gen, device=dev)[:num_queries]]
    size = torch.tensor([(w, h) for h, w in levels], device=dev, dtype=torch.float32)
    offs = sampling_offsets_bias(h_, l_, p_).to(dev).reshape(h_, l_, p_, 2)
    offs = offs + torch.randn(batch, num_queries, h_, l_, p_, 2, generator=gen,
                              device=dev) * 1.5
    locs = refs[None, :, None, None, None] + offs / size[:, None]
    far = locs[:, ::97, :, :, 3]
    far.copy_(torch.rand(far.shape, generator=gen, device=dev) * 1.2 - 0.1)
    past = locs[:, ::89, :, :, 0]
    past.copy_(torch.tensor([-0.05, 1.05], device=dev)[
        torch.randint(0, 2, past.shape, generator=gen, device=dev)])
    attn = torch.rand(batch, num_queries, h_, l_, p_, generator=gen, device=dev)
    attn = attn / attn.sum(dim=(-2, -1), keepdim=True)
    return value, locs.contiguous(), attn.contiguous()


MSDA_SETS = (("encoder-like", msda_encoder_inputs), ("scattered", msda_inputs))


def on_pixel_centres(torch, gen, locs, levels):
    """Fill locs (..., L, 2) in place with pixel centres plus whole-pixel
    offsets, computed as the encoder computes its samples (reference point
    + offset / size): the pixel coordinate lands on an integer, where the
    location gradient has a kink."""
    for lvl, (h, w) in enumerate(levels):
        for axis, size in ((0, w), (1, h)):
            shape = locs[..., lvl, axis].shape
            idx = torch.randint(0, size, shape, generator=gen, device=locs.device)
            off = torch.randint(-2, 3, shape, generator=gen, device=locs.device)
            locs[..., lvl, axis] = (idx + 0.5) / size + off.float() / size


def relation_inputs(torch, gen, n, dev, batch=1):
    """Boxes with w/h from 10**-4.5 to 1 (angles up to ~1e3 rad), one NaN
    centre (the ratio clamp makes its bias finite) and one Inf centre."""
    centres = torch.rand(batch, n, 2, generator=gen, device=dev)
    wh = 10 ** (torch.rand(batch, n, 2, generator=gen, device=dev) * 4.5 - 4.5)
    boxes = torch.cat([centres, wh], -1)
    boxes[0, 3, :2] = float("nan")
    boxes[0, 17, 0] = float("inf")
    src = boxes.contiguous()
    tgt = torch.roll(boxes, 5, dims=1).contiguous()
    kernel = torch.randn(64, 8, generator=gen, device=dev) * 0.1
    bias = torch.randn(8, generator=gen, device=dev) * 0.1
    return src, tgt, kernel, bias


def hold_msda(torch, gen, levels, value, locs, attn, label, shape, found, errs, device):
    """msda_fwd and msda_bwd on one input set against their plain versions,
    timed in turns with them, with bounds: found[key][label] = [kernel ms,
    plain ms, bound ms, bound by], errs[key] the max abs error; phase 10
    profiles both kernels into device[label]."""
    from relation_detr_tpu_torch.ops import msda

    dev, nq = value.device, locs.shape[1]
    with torch.no_grad():
        got = msda.multi_scale_deformable_attention(value, levels, locs, attn)
        want = msda.msda_reference(value, levels, locs, attn)
        torch.cuda.synchronize()
        err = (got - want).abs().max().item()
        if not (err <= TOL_KERNEL):
            raise AssertionError(f"msda_fwd {shape}: max abs err {err} > {TOL_KERNEL}")
        ms, plain_ms = in_turns(
            lambda: msda.msda_reference(value, levels, locs, attn),
            lambda: msda.multi_scale_deformable_attention(value, levels, locs, attn),
            5, 20)
    # 4 corner FMAs and a weight FMA per (q, h, l, p, d)
    fb = bound(msda_value_bytes(torch, value, levels, locs) + size(locs, attn, got),
               10 * got.numel() * 16)
    errs["fwd"].append(err)
    found["fwd"][label] = [ms, plain_ms, fb[0], fb[1]]
    phase(3, f"msda_fwd {shape}: max_abs_err {err:.3e}, kernel {ms:.4f} ms, plain "
             f"{plain_ms:.4f} ms, bound {fb[0]:.4f} ms ({fb[1]})")
    del got, want

    grad_out = torch.randn(value.shape[0], nq, value.shape[2] * value.shape[3], generator=gen,
                           device=dev)
    got = msda.msda_backward(value, levels, locs, attn, grad_out)
    inputs = [t.detach().requires_grad_(True) for t in (value, locs, attn)]
    with torch.enable_grad():
        out = msda.msda_reference(inputs[0], levels, inputs[1], inputs[2])

    def plain():
        return torch.autograd.grad(out, inputs, grad_out, retain_graph=True)

    want = plain()
    torch.cuda.synchronize()
    rel = [max_rel(g, w) for g, w in zip(got, want)]
    err = max((g - w).abs().max().item() for g, w in zip(got, want))
    if not all(r <= TOL_BWD_REL for r in rel):
        raise AssertionError(f"msda_bwd {shape}: max rel err (value, locations, "
                             f"weights) {rel} > {TOL_BWD_REL}")
    ms, plain_ms = in_turns(
        plain, lambda: msda.msda_backward(value, levels, locs, attn, grad_out), 3, 10)
    PROFILES.append((
        f"msda_fwd x20 + msda_bwd x10, {shape}",
        lambda args=(value, locs, attn, grad_out): msda_calls(torch, msda, *args, levels),
        ("msda_fwd_kernel", "msda_bwd_kernel"), device, label))
    # per (q, h, l, p, d): 4 corner atomics, 4 x 2 location FMAs, 4
    # weight FMAs and the sample FMA
    bb = bound(msda_value_bytes(torch, value, levels, locs)
               + size(locs, attn, grad_out, *got), 2 * 17 * grad_out.numel() * 16)
    errs["bwd"].append(err)
    found["bwd"][label] = [ms, plain_ms, bb[0], bb[1]]
    phase(3, f"msda_bwd {shape}: max rel err value {rel[0]:.3e}, locations "
             f"{rel[1]:.3e}, weights {rel[2]:.3e} (max abs {err:.3e}); kernel {ms:.4f} "
             f"ms, plain backward {plain_ms:.4f} ms, bound {bb[0]:.4f} ms ({bb[1]})")


def check_msda_kernels(torch, rows):
    """msda_fwd and msda_bwd against their plain versions at the encoder
    shape (Q = S) and the decoder shapes Q = 300 (the model families' eval,
    and the train of those without denoising), 500 (200 CDN slots + 300),
    600 (DN-Def-DETR++'s train: 5 groups x 60 DN slots + 300), 900 (eval),
    1100 (train: 200 CDN slots + 900) and 1500 (hybrid), each on the encoder-like and
    the scattered set, timed in turns with them. A row's ms is the encoder
    shape on the encoder-like set; shapes_ms lists [kernel, plain, bound]
    for every shape and set."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    total = sum(h * w for h, w in LEVELS)
    found = {"fwd": {}, "bwd": {}}
    errs = {"fwd": [], "bwd": []}
    device = {}  # phase 10: kernel-only device time per shape and set
    for nq in (total, *FAMILY_N, 900, 1100, 1500):
        for set_name, make in MSDA_SETS:
            value, locs, attn = make(torch, gen, nq, dev)
            hold_msda(torch, gen, LEVELS, value, locs, attn, f"Q={nq} {set_name}",
                      f"B=1 Q={nq} S={total} H=8 D=32 L=4 P=4, {set_name}", found, errs, device)
    head = f"Q={total} encoder-like"
    for key, name, library in (("fwd", "msda_fwd", "none: grid_sample takes one level per call"),
                               ("bwd", "msda_bwd", "none: no one backward call")):
        ms, plain_ms, bound_ms, bound_by = found[key][head]
        rows["msda" if key == "fwd" else "msda_bwd"] = dict(
            name=name, route="cuda", source="relation_detr_tpu_torch/csrc/msda.cu",
            replaces="relation_detr_tpu/ops/msda.py:375", max_abs_err=max(errs[key]), ms=ms,
            plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by, library_ms=None,
            library=library, scattered_ms=found[key][f"Q={total} scattered"][0],
            shape=f"encoder B=1 Q=S={total} H=8 D=32 L=P=4, encoder-like set (shapes_ms: "
                  "[kernel, plain, bound] per shape and set)",
            shapes_ms={k: v[:3] for k, v in found[key].items()},
            device_ms=device,
        )


def check_msda_large_canvas(torch, rows):
    """msda_fwd and msda_bwd against their plain versions at the encoder
    shape of LARGE_CANVAS (FocalNet-L at 1200x2000: Q = S = 50,882 over
    levels 152x252, 76x126, 38x63, 19x32), on the encoder-like and the
    scattered set, timed in turns with them, with bounds; phase 10 profiles
    their device time. Stored at each row's ``large_canvas`` ([kernel, plain,
    bound, bound by] per set, ``device_ms``)."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(13)
    levels = canvas_levels(LARGE_CANVAS)
    total = sum(h * w for h, w in levels)
    found = {"fwd": {}, "bwd": {}}
    errs = {"fwd": [], "bwd": []}
    device = {}
    for set_name, make in MSDA_SETS:
        value, locs, attn = make(torch, gen, total, dev, levels)
        hold_msda(torch, gen, levels, value, locs, attn, f"Q={total} {set_name}",
                  f"B=1 Q={total} S={total} levels {levels} H=8 D=32 L=4 P=4, {set_name}",
                  found, errs, device)
    for key, row in (("fwd", "msda"), ("bwd", "msda_bwd")):
        rows[row]["large_canvas"] = dict(canvas=list(LARGE_CANVAS), levels=levels,
                                         device_ms=device, **found[key])
        rows[row]["max_abs_err"] = max(rows[row]["max_abs_err"], *errs[key])


def bf16_rounding_err(got, want):
    """How far a bf16 result is from the fp32 sums it rounds: (max |got -
    want| in bf16 units of want's max (BF16_EPS * max |want|), whether each
    finite element lies within one bf16 rounding, EPS * |want| plus
    ``noise`` of the max for the fp32 sums' order)."""
    got, want = got.float(), want.float()
    both = got.isfinite() & want.isfinite()
    g, w = got[both], want[both]
    scale = w.abs().max().item()
    units = (g - w).abs().max().item() / (BF16_EPS * scale)
    return units, g, w, scale


def check_msda_bf16_kernels(torch, rows):
    """The bf16-value forms msda_fwd_bf16 and msda_bwd_bf16 against their
    plain versions (``msda_reference`` / autograd through it, on the bf16
    value) at phase 3's shapes and sets, timed in turns with them and beside
    the fp32 forms on the same (upcast) value; each bf16 output and
    grad_value within one bf16 rounding of the fp32 sums (error reported in
    bf16 units of the max), the fp32 location and weight gradients within
    TOL_BWD_REL; at Q = 900 also a NaN location and a NaN weight, whose
    NaNs the plain version gives in the same places. Bounds at 2 bytes per
    value, output and output-gradient element."""
    from relation_detr_tpu_torch.ops import msda

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(10)
    total = sum(h * w for h, w in LEVELS)
    found = {"fwd": {}, "bwd": {}}
    errs = {"fwd": [], "bwd": []}
    units = {"fwd": [], "bwd": []}
    device = {}  # phase 10: device time per launch per shape and set
    for nq in (total, 900, 1100, 1500):
        for set_name, make in MSDA_SETS:
            value, locs, attn = make(torch, gen, nq, dev)
            vb = value.to(torch.bfloat16)
            v32 = vb.float()
            label = f"Q={nq} {set_name}"
            shape = f"B=1 Q={nq} S={total} H=8 D=32 L=4 P=4, {set_name}, bf16 value"
            with torch.no_grad():
                got = msda.multi_scale_deformable_attention(vb, LEVELS, locs, attn)
                plain = msda.msda_reference(vb, LEVELS, locs, attn)
                sums = msda.msda_reference(v32, LEVELS, locs, attn)
                torch.cuda.synchronize()
                if got.dtype != torch.bfloat16:
                    raise AssertionError(f"msda_fwd_bf16 {shape}: output {got.dtype}")
                u, g, w, scale = bf16_rounding_err(got, sums)
                if not bool(((g - w).abs() <= BF16_EPS * w.abs() + 1e-5 * scale).all()):
                    raise AssertionError(f"msda_fwd_bf16 {shape}: an output is more than one "
                                         f"bf16 rounding from the fp32 sums ({u:.3f} units)")
                err = (got.float() - plain.float()).abs().max().item()
                ms, plain_ms = in_turns(
                    lambda: msda.msda_reference(vb, LEVELS, locs, attn),
                    lambda: msda.multi_scale_deformable_attention(vb, LEVELS, locs, attn),
                    5, 20)
                fp32_ms = cuda_ms(
                    lambda: msda.multi_scale_deformable_attention(v32, LEVELS, locs, attn), 20)
            fb = bound(msda_value_bytes(torch, vb, LEVELS, locs) + size(locs, attn, got),
                       10 * got.numel() * 16)
            errs["fwd"].append(err)
            units["fwd"].append(u)
            found["fwd"][label] = [ms, plain_ms, fb[0], fp32_ms, fb[1]]
            phase(3, f"msda_fwd_bf16 {shape}: {u:.3f} bf16 units of the max from the fp32 "
                     f"sums (max abs vs plain {err:.3e}); kernel {ms:.4f} ms, plain "
                     f"{plain_ms:.4f} ms, fp32 form {fp32_ms:.4f} ms, bound {fb[0]:.4f} ms "
                     f"({fb[1]})")
            del got, plain, sums

            grad_out = torch.randn(1, nq, 256, generator=gen, device=dev).to(torch.bfloat16)
            got = msda.msda_backward(vb, LEVELS, locs, attn, grad_out)
            sums = msda.msda_backward_reference(v32, LEVELS, locs, attn, grad_out.float())
            inputs = [t.detach().requires_grad_(True) for t in (vb, locs, attn)]
            with torch.enable_grad():
                out = msda.msda_reference(inputs[0], LEVELS, inputs[1], inputs[2])

            def plain():
                return torch.autograd.grad(out, inputs, grad_out, retain_graph=True)

            torch.cuda.synchronize()
            if [t.dtype for t in got] != [torch.bfloat16, torch.float32, torch.float32]:
                raise AssertionError(f"msda_bwd_bf16 {shape}: gradients {[t.dtype for t in got]}")
            u, g, w, scale = bf16_rounding_err(got[0], sums[0])
            if not bool(((g - w).abs() <= BF16_EPS * w.abs() + 1e-4 * scale).all()):
                raise AssertionError(f"msda_bwd_bf16 {shape}: a grad_value element is more than "
                                     f"one bf16 rounding from the fp32 sums ({u:.3f} units)")
            rel = [max_rel(a, b) for a, b in zip(got[1:], sums[1:])]
            if not all(r <= TOL_BWD_REL for r in rel):
                raise AssertionError(f"msda_bwd_bf16 {shape}: max rel err (locations, weights) "
                                     f"{rel} > {TOL_BWD_REL}")
            want = plain()
            err = max((a.float() - b.float()).abs().max().item() for a, b in zip(got, want))
            ms, plain_ms = in_turns(
                plain, lambda: msda.msda_backward(vb, LEVELS, locs, attn, grad_out), 3, 10)
            g32 = grad_out.float()
            fp32_ms = cuda_ms(lambda: msda.msda_backward(v32, LEVELS, locs, attn, g32), 10)
            PROFILES.append((
                f"msda_fwd_bf16 x20 + msda_bwd_bf16 x10, {shape}",
                lambda args=(vb, locs, attn, grad_out): msda_calls(torch, msda, *args),
                ("msda_fwd_kernel", "msda_bwd_kernel", "to_bf16_kernel"), device, label))
            bb = bound(msda_value_bytes(torch, vb, LEVELS, locs)
                       + size(locs, attn, grad_out, *got), 2 * 17 * grad_out.numel() * 16)
            errs["bwd"].append(err)
            units["bwd"].append(u)
            found["bwd"][label] = [ms, plain_ms, bb[0], fp32_ms, bb[1]]
            phase(3, f"msda_bwd_bf16 {shape}: grad_value {u:.3f} bf16 units of the max from "
                     f"the fp32 sums, locations / weights max rel err {rel[0]:.3e} / "
                     f"{rel[1]:.3e} (max abs vs plain {err:.3e}); kernel {ms:.4f} ms, plain "
                     f"backward {plain_ms:.4f} ms, fp32 form {fp32_ms:.4f} ms, bound "
                     f"{bb[0]:.4f} ms ({bb[1]})")
            if nq == 900 and set_name == "encoder-like":
                check_msda_bf16_nan(torch, msda, vb, locs, attn, grad_out)
            del out, inputs, want, got, sums
    head = f"Q={total} encoder-like"
    for key, name, library in (("fwd", "msda_fwd_bf16",
                                "none: grid_sample takes one level per call"),
                               ("bwd", "msda_bwd_bf16", "none: no one backward call")):
        ms, plain_ms, bound_ms, fp32_ms, bound_by = found[key][head]
        rows["msda_bf16" if key == "fwd" else "msda_bwd_bf16"] = dict(
            name=name, route="cuda", source="relation_detr_tpu_torch/csrc/msda.cu",
            replaces="relation_detr_tpu/ops/msda.py:375", max_abs_err=max(errs[key]), ms=ms,
            plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by, library_ms=None,
            library=library, fp32_form_ms=fp32_ms, err_bf16_units=max(units[key]),
            scattered_ms=found[key][f"Q={total} scattered"][0],
            shape=f"encoder B=1 Q=S={total} H=8 D=32 L=P=4, encoder-like set, bf16 value "
                  "(shapes_ms: [kernel, plain, bound, fp32 form] per shape and set)",
            shapes_ms={k: v[:4] for k, v in found[key].items()},
            device_ms=device,
        )


def check_msda_bf16_nan(torch, msda, vb, locs, attn, grad_out):
    """A NaN location through the bf16 forms: the output and the weight
    gradient NaN where the plain version's are (one query and head), the
    value gradient NaN somewhere on both."""
    locs = locs.clone()
    locs[0, 3, 0, 1, 2, 0] = float("nan")
    with torch.no_grad():
        got = msda.multi_scale_deformable_attention(vb, LEVELS, locs, attn)
        want = msda.msda_reference(vb, LEVELS, locs, attn)
    grads = msda.msda_backward(vb, LEVELS, locs, attn, grad_out)
    wants = msda.msda_backward_reference(vb, LEVELS, locs, attn, grad_out)
    torch.cuda.synchronize()
    for what, g, w in (("output", got, want), ("weight gradient", grads[2], wants[2])):
        if not torch.equal(g.isnan(), w.isnan()) or not bool(g.isnan().any()):
            raise AssertionError(f"msda bf16 forms with a NaN location: the {what}'s NaNs "
                                 f"({int(g.isnan().sum())}) are not the plain version's "
                                 f"({int(w.isnan().sum())})")
    if not (bool(grads[0].isnan().any()) and bool(wants[0].isnan().any())):
        raise AssertionError("msda_bwd_bf16 with a NaN location: no NaN in grad_value")
    phase(3, f"msda_fwd_bf16 / msda_bwd_bf16 Q=900 with a NaN location: NaN where the plain "
             f"version's are ({int(got.isnan().sum())} output and "
             f"{int(grads[2].isnan().sum())} weight gradient elements; "
             f"{int(grads[0].isnan().sum())} grad_value elements, plain "
             f"{int(wants[0].isnan().sum())})")


def msda_calls(torch, msda, value, locs, attn, grad_out, levels=LEVELS):
    """msda_fwd 20 times and msda_bwd 10 times on one input set (phase 10
    profiles them: each kernel's device time without the host's gaps)."""
    with torch.no_grad():
        for _ in range(20):
            msda.multi_scale_deformable_attention(value, levels, locs, attn)
    for _ in range(10):
        msda.msda_backward(value, levels, locs, attn, grad_out)


def check_kernels(torch):
    from relation_detr_tpu_torch.ops import relation_bias

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    rows = {}
    check_msda_kernels(torch, rows)

    src, tgt, kernel, bias = relation_inputs(torch, gen, 900, dev)
    with torch.no_grad():
        got = relation_bias.relation_bias_v4(src, tgt, kernel, bias)
        want = relation_bias.relation_bias_v4_reference(src, tgt, kernel, bias)
        torch.cuda.synchronize()
        finite = torch.isfinite(want)
        if not torch.equal(finite, torch.isfinite(got)) or not bool(finite.all()):
            raise AssertionError("relation bias: the clamped NaN/Inf boxes must give "
                                 "the same finite biases in kernel and plain version")
        err = (got - want).abs().max().item()
        if not (err <= TOL_KERNEL):
            raise AssertionError(f"relation bias: max abs err {err} > {TOL_KERNEL}")
        ms, plain_ms = in_turns(
            lambda: relation_bias.relation_bias_v4_reference(src, tgt, kernel, bias),
            lambda: relation_bias.relation_bias_v4(src, tgt, kernel, bias), 10, 50,
        )
    v4_bound = relation_v4_bound(src, tgt, kernel, bias, got)
    phase(3, f"relation_bias_v4_fwd B=1 N1=N2=900 H=8: max_abs_err {err:.3e}, "
             f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, bound {v4_bound[0]:.4f} ms "
             f"({v4_bound[1]})")
    device = {}  # phase 10: the kernel's device time per launch at each N
    PROFILES.append(("relation_bias_v4_fwd x20, B=1 N1=N2=900 H=8",
                     lambda args=(src, tgt, kernel, bias): relation_calls(torch, *args),
                     ("relation_bias_v4_kernel",), device, "N=900"))
    rows["relation"] = dict(
        name="relation_bias_v4_fwd", route="cuda",
        source="relation_detr_tpu_torch/csrc/relation_bias.cu",
        replaces="relation_detr_tpu/ops/relation_pallas.py:164", max_abs_err=err,
        ms=ms, plain_ms=plain_ms, bound_ms=v4_bound[0], bound_by=v4_bound[1],
        library_ms=None, library="none: no one call builds the pair features",
        shape="B=1 N1=N2=900 H=8 E=16", device_ms=device,
    )
    check_relation_family_shapes(torch, gen, rows["relation"])
    return rows


def check_relation_family_shapes(torch, gen, row):
    """relation_bias_v4_fwd against its plain version at the model
    families' N (FAMILY_N: not multiples of the kernel's 128-column tile,
    so its tail warps run at new offsets), timed in turns, each with its
    bound and (phase 10) its device time per launch: row["family_shapes_ms"]
    holds [kernel, plain, bound] per N."""
    from relation_detr_tpu_torch.ops import relation_bias

    shapes = {}
    for n in FAMILY_N:
        src, tgt, kernel, bias = relation_inputs(torch, gen, n, "cuda")
        with torch.no_grad():
            got = relation_bias.relation_bias_v4(src, tgt, kernel, bias)
            want = relation_bias.relation_bias_v4_reference(src, tgt, kernel, bias)
            torch.cuda.synchronize()
            if not torch.equal(torch.isfinite(got), torch.isfinite(want)) or \
                    not bool(torch.isfinite(want).all()):
                raise AssertionError(f"relation bias N={n}: non-finite biases")
            err = (got - want).abs().max().item()
            if not (err <= TOL_KERNEL):
                raise AssertionError(f"relation bias N={n}: max abs err {err} > {TOL_KERNEL}")
            ms, plain_ms = in_turns(
                lambda: relation_bias.relation_bias_v4_reference(src, tgt, kernel, bias),
                lambda: relation_bias.relation_bias_v4(src, tgt, kernel, bias), 10, 50)
        nb = relation_v4_bound(src, tgt, kernel, bias, got)
        PROFILES.append((f"relation_bias_v4_fwd x20, B=1 N1=N2={n} H=8",
                         lambda args=(src, tgt, kernel, bias): relation_calls(torch, *args),
                         ("relation_bias_v4_kernel",), row["device_ms"], f"N={n}"))
        shapes[f"N={n}"] = [ms, plain_ms, nb[0]]
        row["max_abs_err"] = max(row["max_abs_err"], err)
        phase(3, f"relation_bias_v4_fwd B=1 N1=N2={n} H=8: max_abs_err {err:.3e}, kernel "
                 f"{ms:.4f} ms, plain {plain_ms:.4f} ms, bound {nb[0]:.4f} ms ({nb[1]})")
    row["family_shapes_ms"] = shapes


def relation_v4_bound(src, tgt, kernel, bias, out):
    """Bound of relation_bias_v4_fwd: the boxes, weights and bias in, the
    bias out; per pair 32 sines and cosines (one operation each) and 2 x 32
    FMAs per head (xy and wh halves). The per-box wh features (O(N)) are
    left out."""
    pairs = out.numel() // out.shape[1]
    return bound(size(src, tgt, kernel, bias, out), pairs * (32 + 2 * 2 * 32 * out.shape[1]))


def relation_calls(torch, src, tgt, kernel, bias):
    """relation_bias_v4 20 times (phase 10 profiles its kernel)."""
    from relation_detr_tpu_torch.ops import relation_bias

    with torch.no_grad():
        for _ in range(20):
            relation_bias.relation_bias_v4(src, tgt, kernel, bias)


def max_rel(got, want):
    return ((got - want).abs().max() / want.abs().max().clamp_min(1e-30)).item()


def check_backward_kernels(torch, rows):
    from relation_detr_tpu_torch.ops import patch_scatter, relation_bias
    from relation_detr_tpu_torch.ops.tile_geometry import MARGIN, TILE_TOKENS, _tile_geometry

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(1)
    src, tgt, kernel, bias = relation_inputs(torch, gen, 1100, dev)
    with torch.no_grad():  # the train path's shape: 200 CDN slots + 900 queries
        fwd = relation_bias.relation_bias_v4(src, tgt, kernel, bias)
        fwd_want = relation_bias.relation_bias_v4_reference(src, tgt, kernel, bias)
        torch.cuda.synchronize()
        fwd_err = (fwd - fwd_want).abs().max().item()
    if not (fwd_err <= TOL_KERNEL):
        raise AssertionError(f"relation bias N=1100: max abs err {fwd_err} > {TOL_KERNEL}")
    with torch.no_grad():
        n1100_ms, n1100_plain_ms = in_turns(
            lambda: relation_bias.relation_bias_v4_reference(src, tgt, kernel, bias),
            lambda: relation_bias.relation_bias_v4(src, tgt, kernel, bias), 10, 50)
    n1100_bound = relation_v4_bound(src, tgt, kernel, bias, fwd)
    PROFILES.append(("relation_bias_v4_fwd x20, B=1 N1=N2=1100 H=8",
                     lambda args=(src, tgt, kernel.detach(), bias.detach()):
                     relation_calls(torch, *args),
                     ("relation_bias_v4_kernel",), rows["relation"]["device_ms"], "N=1100"))
    del fwd, fwd_want
    cot = torch.randn(1, 8, 1100, 1100, generator=gen, device=dev)
    k, b = kernel.requires_grad_(True), bias.requires_grad_(True)
    got = torch.autograd.grad(relation_bias.relation_bias_v4(src, tgt, k, b), (k, b), cot)
    out = relation_bias.relation_bias_v4_reference(src, tgt, k, b)

    def plain_rel():
        return torch.autograd.grad(out, (k, b), cot, retain_graph=True)

    want = plain_rel()
    torch.cuda.synchronize()
    rel = [max_rel(g, w) for g, w in zip(got, want)]
    if not all(r <= TOL_BWD_REL for r in rel):
        raise AssertionError(f"relation bias backward: max rel err (kernel, bias) {rel}")
    ms, plain_ms = in_turns(
        plain_rel,
        lambda: relation_bias.relation_bias_v4_backward(src, tgt, kernel, bias, cot), 3, 5)
    phase(3, f"relation_bias_v4_fwd B=1 N1=N2=1100 H=8: max_abs_err {fwd_err:.3e}, kernel "
             f"{n1100_ms:.4f} ms, plain {n1100_plain_ms:.4f} ms, bound {n1100_bound[0]:.4f} ms "
             f"({n1100_bound[1]}); relation "
             f"bias backward (RelationBiasFunction: plain separable recompute, not a kernel): "
             f"max rel err kernel {rel[0]:.3e}, bias {rel[1]:.3e}; {ms:.4f} ms, plain autograd "
             f"backward {plain_ms:.4f} ms")
    rows["relation"].update(max_abs_err=max(rows["relation"]["max_abs_err"], fwd_err),
                            max_abs_err_n1100=fwd_err, n1100_ms=n1100_ms,
                            n1100_plain_ms=n1100_plain_ms, n1100_bound_ms=n1100_bound[0],
                            backward_ms=ms,
                            backward_plain_ms=plain_ms)
    del out, cot

    # window_accumulate at the four levels' window grids, keyed by the band
    # grid as the train path's SlicePatchesFunction keys its device table
    geo = _tile_geometry(LEVELS, TILE_TOKENS, (5,) * len(LEVELS), MARGIN)
    levels_ms, builds = {}, 0
    for lvl, ((h, w), (y0a, x0a, ph, pw)) in enumerate(zip(LEVELS, geo.patches)):
        y0s, x0s = tuple(int(v) for v in y0a), tuple(int(v) for v in x0a)
        grid = geo.patch_grid[lvl]
        g = torch.randn(len(y0s), ph, pw, 256, generator=gen, device=dev)
        before = patch_scatter.window_table.builds
        got = patch_scatter.window_accumulate(g, y0s, x0s, h, w, grid=grid)
        want = patch_scatter.window_accumulate_reference(g, y0s, x0s, h, w)
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            raise AssertionError(f"window_accumulate level {lvl}: not bit-identical to the "
                                 "ascending slice-add loop (max abs err "
                                 f"{(got - want).abs().max().item()})")
        # the library call: one index_add over every window element's canvas row
        rows_of = (torch.as_tensor(y0a, device=dev)[:, None, None]
                   + torch.arange(ph, device=dev)[:, None]) * w \
            + torch.as_tensor(x0a, device=dev)[:, None, None] + torch.arange(pw, device=dev)
        rows_of = rows_of.reshape(-1).long()
        zeros = torch.zeros(h * w, 256, device=dev)
        flat = g.reshape(-1, 256)
        lib_out = torch.index_add(zeros, 0, rows_of, flat).reshape(h, w, 256)
        lib_err = (lib_out - want).abs().max().item()
        ms, plain_ms, lib_ms = in_turns(
            lambda: patch_scatter.window_accumulate_reference(g, y0s, x0s, h, w),
            lambda: patch_scatter.window_accumulate(g, y0s, x0s, h, w, grid=grid), 5, 20,
            library=lambda: torch.index_add(zeros, 0, rows_of, flat))
        made = patch_scatter.window_table.builds - before
        if made != 1:
            raise AssertionError(f"window_accumulate level {lvl}: {made} covering-window table "
                                 "builds over 1 + 2 x 22 calls, expected 1 (the first)")
        builds += made
        win_bound = bound(size(g, got), g.numel())
        levels_ms[f"L{lvl}"] = [ms, plain_ms, win_bound[0], lib_ms]
        phase(3, f"window_accumulate level {lvl} {len(y0s)} windows of {ph}x{pw}x256 onto "
                 f"{h}x{w}x256: bit-identical to plain, kernel {ms:.4f} ms, plain "
                 f"{plain_ms:.4f} ms, index_add {lib_ms:.4f} ms (max abs diff {lib_err:.3e}), "
                 f"bound {win_bound[0]:.4f} ms ({win_bound[1]}); one covering-window table "
                 "build, at the first call")
        if lvl == 0:
            rows["window"] = dict(
                name="window_accumulate", route="cuda",
                source="relation_detr_tpu_torch/csrc/patch_scatter.cu",
                replaces="relation_detr_tpu/ops/patch_scatter.py:39", max_abs_err=0.0,
                ms=ms, plain_ms=plain_ms, bound_ms=win_bound[0], bound_by=win_bound[1],
                library_ms=lib_ms, library="torch.index_add over precomputed canvas rows",
                shape=f"level 0: nt={len(y0s)} ph={ph} pw={pw} C=256 on {h}x{w} (levels_ms: "
                      "per level [kernel, plain, bound, index_add])",
            )
        del g, got, want, lib_out, zeros, rows_of
    rows["window"].update(levels_ms=levels_ms, table_builds=builds)


def adversarial_entries(torch, m, rows):
    """m (B, nt, H, E, T) with the patterns the backward must survive:
    entries outside [0, rows) (-1, rows, 10**6), a row that no entry hits
    (rows // 2), and a row (rows - 1) that every entry of the first
    (image, tile, head) hits."""
    m = m.clone()
    m[m == rows // 2] = rows // 2 + 1
    m[..., :3, ::5] = torch.tensor([-1, rows, 10 ** 6], dtype=torch.int32,
                                   device=m.device)[:, None]
    m[0, 0, 0] = rows - 1
    return m


def edge_entries(torch, m, wt, rows):
    """m, w (B, nt, H, E, T) with entries outside [0, rows) (-1, rows, 10**6,
    -10**6 on entries 0-3 of every 5th token slot), NaN weights on entries
    0-3 of every 10th slot (outside: dropped) and on one entry inside (item
    (0, 0, 0), entry 5, slot 0: NaN for that token's 32 channels of head 0)."""
    m, wt = m.clone(), wt.clone()
    m[..., :4, ::5] = torch.tensor([-1, rows, 10 ** 6, -10 ** 6], dtype=torch.int32,
                                   device=m.device)[:, None]
    wt[..., :4, ::10] = float("nan")
    m[0, 0, 0, 5, 0] = rows - 1
    wt[0, 0, 0, 5, 0] = float("nan")
    return m, wt


def tiled_core_calls(torch, m, wt, patch, dims):
    """tiled_matmul_core 20 times (phase 10 profiles its kernel)."""
    from relation_detr_tpu_torch.ops import msda_tiled

    with torch.no_grad():
        for _ in range(20):
            msda_tiled.tiled_matmul_core(m, wt, patch, dims)


def relation_rel_calls(torch, rel, kernel, bias):
    """fused_relation_bias 20 times (phase 10 profiles its kernel)."""
    from relation_detr_tpu_torch.ops import relation_bias

    with torch.no_grad():
        for _ in range(20):
            relation_bias.fused_relation_bias(rel, kernel, bias)


def tiled_inputs(torch, gen, bs, dev, levels=LEVELS):
    """Encoder inputs in the tiled forms' regime: every token samples near
    its own raster position, up to num_points = 4 texels off on each level
    (the reach of the radial offset initialisation, inside the auto halos
    of 5)."""
    total = sum(h * w for h, w in levels)
    value = torch.randn(bs, total, 8, 32, generator=gen, device=dev)
    refs = torch.cat([torch.stack(torch.meshgrid((torch.arange(w, device=dev) + 0.5) / w,
                                                 (torch.arange(h, device=dev) + 0.5) / h,
                                                 indexing="xy"), -1).reshape(-1, 2)
                      for h, w in levels])
    texel = torch.tensor([(w, h) for h, w in levels], device=dev, dtype=torch.float32)
    offs = torch.rand(bs, total, 8, len(levels), 4, 2, generator=gen, device=dev) * 8 - 4
    locs = (refs[None, :, None, None, None] + offs / texel[:, None]).contiguous()
    attn = torch.rand(bs, total, 8, len(levels), 4, generator=gen, device=dev)
    attn = attn / attn.sum(dim=(-2, -1), keepdim=True)
    return value, locs, attn


def check_tiled_kernels(torch, rows):
    """tiled_core_fwd, tiled_core_bwd and sep_contract_fwd on the operands
    the tiled MSDA builds at the flagship's four levels (B=1, and level 0
    at B=2), and relation_bias_rel_fwd at N = 900 and 1100, each against
    its plain version and timed in turns with it."""
    from relation_detr_tpu_torch.models.relation import box_rel_encoding
    from relation_detr_tpu_torch.ops import msda_tiled, relation_bias

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(6)
    found = {k: dict(errs=[], times=[]) for k in ("fwd", "bwd", "sep")}
    fwd_device = {}  # phase 10: tiled_core_fwd's device time per (B, level)
    for bs, lvls in ((1, range(4)), (2, range(1))):
        value, locs, attn = tiled_inputs(torch, gen, bs, dev)
        with torch.no_grad():
            consts, levels = msda_tiled.tiled_level_operands(value, LEVELS, locs, attn)
        for lvl in lvls:
            op = levels[lvl]
            x0i, y0i, fx, fy, at, bx, by = op["sample"]
            ph, pw, h, w = op["ph"], op["pw"], op["h"], op["w"]
            patch = op["patch"]
            with torch.no_grad():
                m, wt = msda_tiled._tiled_entries(x0i, y0i, fx, fy, at, bx, by, ph, pw, h, w)
                oy = msda_tiled._axis_soft(y0i, fy, by, ph, h, at).contiguous()
                ox = msda_tiled._axis_soft(x0i, fx, bx, pw, w, None).contiguous()
                g = torch.randn(bs, consts["nt"], consts["T"], 256, generator=gen, device=dev)
                dims = (8, 32)
                shape = (f"B={bs} level {lvl} {h}x{w}: nt={consts['nt']} T={consts['T']} "
                         f"M={ph * pw} ({ph}x{pw}) H=8 D=32 E=16")

                def plain():
                    return msda_tiled.tiled_core_reference(m, wt, patch, dims)

                def kernel():
                    return msda_tiled.tiled_matmul_core(m, wt, patch, dims)

                err = (kernel() - plain()).abs().max().item()
                if not (err <= TOL_TILED):
                    raise AssertionError(f"tiled_core_fwd {shape}: max abs err {err}")
                if bs == 1 and lvl == 0:
                    edge = edge_entries(torch, m, wt, ph * pw)
                    got = msda_tiled.tiled_matmul_core(*edge, patch, dims)
                    want = msda_tiled.tiled_core_reference(*edge, patch, dims)
                    nan = torch.isnan(want)
                    edge_err = (got[~nan] - want[~nan]).abs().max().item()
                    if not torch.equal(nan, torch.isnan(got)) or int(nan.sum()) != 32 or \
                            not (edge_err <= TOL_TILED):
                        raise AssertionError(f"tiled_core_fwd {shape}, edge entries: "
                                             f"{int(nan.sum())} NaN outputs (plain), "
                                             f"{int(torch.isnan(got).sum())} (kernel), max abs "
                                             f"err {edge_err}")
                    found["fwd"]["edge_max_abs_err"] = edge_err
                    phase(3, f"tiled_core_fwd {shape} with entries outside [0, M) (-1, M, "
                             f"10**6, -10**6; NaN weights on some: dropped) and a NaN weight on "
                             f"one inside: the same 32 NaN outputs as the plain version, max abs "
                             f"err {edge_err:.3e} elsewhere")
                    del edge, got, want
                ms, plain_ms = in_turns(plain, kernel, 2, 10)
                # per entry and channel one FMA
                b_fwd = bound(size(m, wt, patch) + size(g), 2 * m.numel() * 32)
                found["fwd"]["errs"].append(err)
                found["fwd"]["times"].append((bs, lvl, ms, plain_ms, None, b_fwd))
                phase(3, f"tiled_core_fwd {shape}: max_abs_err {err:.3e}, kernel {ms:.4f} ms, "
                         f"plain {plain_ms:.4f} ms, bound {b_fwd[0]:.4f} ms ({b_fwd[1]})")
                # phase 10: device time per launch, the operands kept on the host
                # meanwhile (the flagship phases' peak memory stays as it was)
                PROFILES.append((f"tiled_core_fwd x20, {shape}",
                                 lambda args=(m.cpu(), wt.cpu(), patch.cpu()), dims=dims:
                                 tiled_core_calls(torch, *(a.cuda() for a in args), dims),
                                 ("tiled_core_fwd_kernel",), fwd_device, f"B{bs} L{lvl}"))

                got = msda_tiled.tiled_core_backward(m, wt, patch, g, dims)
                want = msda_tiled.tiled_core_backward_reference(m, wt, patch, g, dims)
                rel = [max_rel(a, b) for a, b in zip(got, want)]
                err = max((a - b).abs().max().item() for a, b in zip(got, want))
                if not all(r <= TOL_BWD_REL for r in rel):
                    raise AssertionError(f"tiled_core_bwd {shape}: max rel err (dw, dpatch) {rel}")
                again = msda_tiled.tiled_core_backward(m, wt, patch, g, dims)
                if not all(torch.equal(a, b) for a, b in zip(got, again)):
                    raise AssertionError(f"tiled_core_bwd {shape}: two launches differ")
                del again
                if bs == 1 and lvl == 0:
                    m_adv = adversarial_entries(torch, m, ph * pw)
                    adv = [max_rel(a, b) for a, b in zip(
                        msda_tiled.tiled_core_backward(m_adv, wt, patch, g, dims),
                        msda_tiled.tiled_core_backward_reference(m_adv, wt, patch, g, dims))]
                    if not all(r <= TOL_BWD_REL for r in adv):
                        raise AssertionError(f"tiled_core_bwd {shape}, adversarial entries: max "
                                             f"rel err (dw, dpatch) {adv}")
                    found["bwd"]["adversarial"] = adv
                    phase(3, f"tiled_core_bwd {shape} with entries outside [0, M), a row no "
                             f"entry hits and a row every entry of one item hits: max rel err "
                             f"dw {adv[0]:.3e}, dpatch {adv[1]:.3e}")
                    del m_adv
                ms, plain_ms = in_turns(
                    lambda: msda_tiled.tiled_core_backward_reference(m, wt, patch, g, dims),
                    lambda: msda_tiled.tiled_core_backward(m, wt, patch, g, dims), 2, 10)
                # per entry and channel: the dw product and sum, the dpatch FMA
                b_bwd = bound(size(m, wt, patch, g, *got), 4 * m.numel() * 32)
                found["bwd"]["errs"].append(err)
                found["bwd"]["times"].append((bs, lvl, ms, plain_ms, None, b_bwd))
                phase(3, f"tiled_core_bwd {shape}: max rel err dw {rel[0]:.3e}, dpatch "
                         f"{rel[1]:.3e} (max abs {err:.3e}), two launches bit-identical; "
                         f"kernel {ms:.4f} ms, plain "
                         f"{plain_ms:.4f} ms, bound {b_bwd[0]:.4f} ms ({b_bwd[1]})")
                del got, want

                patch6 = patch.reshape(bs, consts["nt"], ph, pw, 8, 32)
                want = msda_tiled.sep_contract_reference(oy, ox, patch)
                got = msda_tiled.sep_contract_fused(oy, ox, patch)
                lib = torch.einsum("bnhpyt,bnhpxt,bnyxhd->bnthd", oy, ox, patch6)
                err = (got - want).abs().max().item()
                lib_err = (lib.reshape(got.shape) - want).abs().max().item()
                if not (err <= TOL_TILED):
                    raise AssertionError(f"sep_contract_fwd {shape}: max abs err {err}")
                ms, plain_ms, lib_ms = in_turns(
                    lambda: msda_tiled.sep_contract_reference(oy, ox, patch),
                    lambda: msda_tiled.sep_contract_fused(oy, ox, patch), 2, 10,
                    library=lambda: torch.einsum("bnhpyt,bnhpxt,bnyxhd->bnthd", oy, ox, patch6))
                # per head: the A build (P FMAs per entry) and the contraction
                # (one FMA per entry and channel)
                b_sep = bound(size(oy, ox, patch, got),
                              2 * bs * consts["nt"] * 8 * ph * pw * consts["T"] * (4 + 32))
                found["sep"]["errs"].append(err)
                found["sep"]["times"].append((bs, lvl, ms, plain_ms, lib_ms, b_sep))
                phase(3, f"sep_contract_fwd {shape} P=4: max_abs_err {err:.3e}, kernel "
                         f"{ms:.4f} ms, plain {plain_ms:.4f} ms, 3-operand torch.einsum "
                         f"{lib_ms:.4f} ms (max abs diff {lib_err:.3e}), bound {b_sep[0]:.4f} ms "
                         f"({b_sep[1]})")
                del got, want, lib
        del value, locs, attn, consts, levels

    for key, name, source, replaces, library in (
        ("fwd", "tiled_core_fwd", "tiled_msda.cu", "relation_detr_tpu/ops/msda_pallas.py:67",
         "none: no one call takes (row, weight) entries"),
        ("bwd", "tiled_core_bwd", "tiled_msda.cu", "relation_detr_tpu/ops/msda_pallas.py:78",
         "none: no one backward call"),
        ("sep", "sep_contract_fwd", "tiled_msda.cu",
         "relation_detr_tpu/ops/msda_sep_pallas.py:66", "3-operand torch.einsum"),
    ):
        times = found[key]["times"]
        _, _, ms, plain_ms, lib_ms, (bound_ms, bound_by) = times[0]  # level 0, B=1
        rows[name] = dict(
            name=name, route="cuda", source=f"relation_detr_tpu_torch/csrc/{source}",
            replaces=replaces, max_abs_err=max(found[key]["errs"]), ms=ms, plain_ms=plain_ms,
            bound_ms=bound_ms, bound_by=bound_by, library_ms=lib_ms, library=library,
            shape="level 0 B=1: nt=189 T=128 M=437 H=8 D=32 (levels_ms: per (B, level) "
                  "[kernel, plain, bound] and the library call's, where there is one)",
            levels_ms={f"B{b} L{lv}": [k, p, bd[0]] + ([lib] if lib is not None else [])
                       for b, lv, k, p, lib, bd in times},
        )
    rows["tiled_core_bwd"].update(deterministic=True,
                                  adversarial_max_rel=found["bwd"]["adversarial"])
    rows["tiled_core_fwd"].update(edge_max_abs_err=found["fwd"]["edge_max_abs_err"],
                                  device_ms=fwd_device)

    errs, times = [], []
    rel_device = {}  # phase 10: the kernel's device time per launch at N = 900 and 1100
    for n in (900, 1100):
        src, tgt, kernel, bias = relation_inputs(torch, gen, n, dev)
        rel = box_rel_encoding(src, tgt)
        with torch.no_grad():
            got = relation_bias.fused_relation_bias(rel, kernel, bias)
            want = relation_bias.fused_relation_bias_reference(rel, kernel, bias)
            torch.cuda.synchronize()
            finite = torch.isfinite(want)
            if not torch.equal(finite, torch.isfinite(got)):
                raise AssertionError("relation_bias_rel_fwd: NaN pattern differs from plain")
            err = (got[finite] - want[finite]).abs().max().item()
            if not (err <= TOL_TILED):
                raise AssertionError(f"relation_bias_rel_fwd N={n}: max abs err {err}")
            ms, plain_ms = in_turns(
                lambda: relation_bias.fused_relation_bias_reference(rel, kernel, bias),
                lambda: relation_bias.fused_relation_bias(rel, kernel, bias), 5, 20)
        # per pair: 64 sin/cos (one operation each) and 64 FMAs per head
        b_rel = bound(size(rel, kernel, bias, got), n * n * (64 + 2 * 64 * 8))
        errs.append(err)
        times.append((ms, plain_ms, b_rel))
        phase(3, f"relation_bias_rel_fwd B=1 N1=N2={n} H=8 (rel from boxes with a NaN and an "
                 f"Inf centre: {int((~finite).sum())} NaN biases in both): max_abs_err "
                 f"{err:.3e}, kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, bound "
                 f"{b_rel[0]:.4f} ms ({b_rel[1]})")
        PROFILES.append((f"relation_bias_rel_fwd x20, B=1 N1=N2={n} H=8",
                         lambda args=(rel, kernel, bias): relation_rel_calls(torch, *args),
                         ("relation_bias_rel_kernel",), rel_device, f"N={n}"))
        if n == 900:
            edge = rel.clone()
            # |rel| up to 90 (angles to 9e3 rad) on every 35th pair, a NaN and an Inf
            edge[:, ::7, ::5] = torch.rand(edge[:, ::7, ::5].shape, generator=gen,
                                           device=dev) * 180 - 90
            edge[0, 10, 20, 1] = float("nan")
            edge[0, 30, 40, 3] = float("inf")
            with torch.no_grad():
                got = relation_bias.fused_relation_bias(edge, kernel, bias)
                want = relation_bias.fused_relation_bias_reference(edge, kernel, bias)
            finite = torch.isfinite(want)
            edge_err = (got[finite] - want[finite]).abs().max().item()
            if not torch.equal(finite, torch.isfinite(got)) or bool(finite[0, :, 10, 20].any()) \
                    or not (edge_err <= TOL_TILED):
                raise AssertionError(f"relation_bias_rel_fwd N={n}, |rel| to 90 and NaN / Inf "
                                     f"rel: NaN pattern or max abs err {edge_err}")
            phase(3, f"relation_bias_rel_fwd N1=N2={n} with |rel| up to 90 (angles to 9e3 rad) "
                     f"on every 35th pair and a NaN and an Inf rel: {int((~finite).sum())} NaN "
                     f"biases in both, max abs err {edge_err:.3e} elsewhere")
            del edge
    rows["relation_rel"] = dict(
        name="relation_bias_rel_fwd", route="cuda",
        source="relation_detr_tpu_torch/csrc/relation_bias_rel.cu",
        replaces="relation_detr_tpu/ops/relation_pallas.py:89",
        also_replaces="relation_detr_tpu/ops/relation_pallas.py:69", max_abs_err=max(errs),
        ms=times[0][0], plain_ms=times[0][1], bound_ms=times[0][2][0],
        bound_by=times[0][2][1], library_ms=None,
        library="none: no one call builds the sine features", shape="B=1 N1=N2=900 H=8 E=16",
        n1100_ms=times[1][0], n1100_plain_ms=times[1][1], n1100_bound_ms=times[1][2][0],
        edge_max_abs_err=edge_err, device_ms=rel_device,
    )


class TopkRecorder:
    """Records every two-stage top-k (encoder, hybrid): selected class
    logits, boxes and indices (``indices``), and what it selected from, the
    class logits and boxes of every proposal (``candidates``)."""

    def __init__(self):
        from relation_detr_tpu_torch.models.transformer import RelationTransformer

        self.cls = RelationTransformer
        self.select = RelationTransformer._select_topk
        self.indices = []
        self.candidates = []

    def __enter__(self):
        def recording(*args):
            out = self.select(*args)
            self.indices.append([t.detach().cpu() for t in out])
            self.candidates.append([t.detach().clone() for t in args[:2]])
            return out

        self.cls._select_topk = staticmethod(recording)
        return self

    def __exit__(self, *exc):
        self.cls._select_topk = staticmethod(self.select)


class PinnedTopk:
    """Gives every two-stage top-k (encoder, hybrid), in call order, the
    indices another run's ``TopkRecorder`` recorded, so that two runs whose
    roundings reorder near-equal proposals decode the same ones."""

    def __init__(self, recorded):
        from relation_detr_tpu_torch.models.transformer import RelationTransformer

        self.cls = RelationTransformer
        self.select = RelationTransformer._select_topk
        self.recorded = recorded
        self.calls = 0

    def __enter__(self):
        import torch

        def pinned(class_logits, coords, k):
            index = self.recorded[self.calls][2].to(class_logits.device)
            self.calls += 1
            return (torch.gather(class_logits, 1,
                                 index[..., None].expand(-1, -1, class_logits.shape[-1])),
                    torch.gather(coords, 1, index[..., None].expand(-1, -1, 4)), index)

        self.cls._select_topk = staticmethod(pinned)
        return self

    def __exit__(self, *exc):
        self.cls._select_topk = staticmethod(self.select)


class PinnedKinks:
    """Pins the train path's kinks to the side another run took. Without
    ``record`` it records, in call order, every MSDA call's sampling
    locations (``models.attention``) and which inputs of every ReLU in the
    backbone are positive. With the ``record`` of another run, each MSDA
    call samples at the recorded locations and each backbone ReLU passes
    the inputs the record's passed, while the gradient still flows to this
    run's own tensors; so does each DCN's ``bilinear_sample`` call with its
    points; ``flips`` counts the MSDA and DCN samples whose bilinear cell
    (the floor of the pixel coordinate) and the ReLU inputs whose sign
    differed from the record's. ``layers`` also pins the ReLUs of the
    transformer's encoder and decoder layers (their FFNs), of its MLPs (the
    box heads, ``ref_point_head``, ``query_scale``) and of the memory
    fusion. (The relation bias' ReLU stays unpinned: the card's kernel
    computes it inside.)"""

    def __init__(self, model, record=None, layers=False):
        import torch
        from relation_detr_tpu_torch.models import attention, deform_conv

        self.torch, self.attention, self.model = torch, attention, model
        self.msda, self.relu = attention.multi_scale_deformable_attention, torch.relu
        self.deform_conv, self.sample = deform_conv, deform_conv.bilinear_sample
        self.record, self.layers = record, layers
        self.locations, self.signs, self.points = [], [], []
        self.flips = {"msda": 0, "relu": 0, "dcn": 0}
        self.hooks = []

    def _sample(self, feat, points):
        if self.record is None:
            self.points.append(points.detach().cpu())
            return self.sample(feat, points)
        want = self.record.points[len(self.points)].to(points.device)
        self.points.append(None)
        cells = [self.torch.floor(t) for t in (points.detach(), want)]
        self.flips["dcn"] += int((cells[0] != cells[1]).any(-1).sum())
        return self.sample(feat, want + (points - points.detach()))

    def _msda(self, value, shapes, locs, weights):
        if self.record is None:
            self.locations.append(locs.detach().cpu())
            return self.msda(value, shapes, locs, weights)
        want = self.record.locations[len(self.locations)].to(locs.device)
        self.locations.append(None)
        size = self.torch.tensor([(w, h) for h, w in shapes], dtype=locs.dtype,
                                 device=locs.device)[:, None, :]
        cells = [self.torch.floor(t * size - 0.5) for t in (locs.detach(), want)]
        self.flips["msda"] += int((cells[0] != cells[1]).any(-1).sum())
        return self.msda(value, shapes, want + (locs - locs.detach()), weights)

    def _relu(self, x):
        if self.record is None:
            self.signs.append((x > 0).cpu())
            return self.relu(x)
        want = self.record.signs[len(self.signs)].to(x.device)
        self.signs.append(None)
        self.flips["relu"] += int((want != (x > 0)).sum())
        return self.torch.where(want, x, 0.0)

    def __enter__(self):
        torch = self.torch
        self.attention.multi_scale_deformable_attention = self._msda
        self.deform_conv.bilinear_sample = self._sample
        scopes = [self.model.backbone]
        if self.layers:
            from relation_detr_tpu_torch.models.layers import MLP

            transformer = self.model.transformer
            scopes += [*transformer.encoder.layers, *transformer.decoder.layers,
                       *(m for m in transformer.modules() if isinstance(m, MLP))]
            if transformer.encoder.memory_fusion is not None:  # its nn.ReLU (called alone)
                scopes.append(transformer.encoder.memory_fusion[1])
        self.hooks = [hook for scope in scopes for hook in (
            scope.register_forward_pre_hook(lambda *_: setattr(torch, "relu", self._relu)),
            scope.register_forward_hook(lambda *_: setattr(torch, "relu", self.relu)))]
        return self

    def __exit__(self, *exc):
        self.attention.multi_scale_deformable_attention = self.msda
        self.deform_conv.bilinear_sample = self.sample
        self.torch.relu = self.relu
        for hook in self.hooks:
            hook.remove()


class RelationVersion:
    """Context for phase 4: relation bias ``version`` (None: the default)
    on the card through ``set_fused_relation``, and on the CPU model given
    the same version's plain version (CPU tensors otherwise take the v4
    math's, whatever the setting): for versions 1 and 2 each relation
    module of cpu_model computes ``fused_relation_bias`` over
    ``box_rel_encoding``, as the card's does. ``check`` asserts that the
    card launched relation_bias_rel_fwd inside the context."""

    def __init__(self, version, cpu_model):
        self.version, self.cpu_model, self.patched = version, cpu_model, []

    def __enter__(self):
        from relation_detr_tpu_torch.models.relation import PositionRelationEmbedding
        from relation_detr_tpu_torch.ops import relation_bias

        self.launches = relation_bias.fused_relation_bias.launches
        if self.version is None:
            return self
        relation_bias.set_fused_relation(version=self.version)
        for mod in self.cpu_model.modules():
            if isinstance(mod, PositionRelationEmbedding):
                mod.forward = lambda src, tgt, mod=mod: self.plain(mod, src, tgt)
                self.patched.append(mod)
        return self

    @staticmethod
    def plain(mod, src, tgt):
        from relation_detr_tpu_torch.models.relation import box_rel_encoding
        from relation_detr_tpu_torch.ops import relation_bias

        conv = mod.pos_proj[0]
        kernel = conv.weight.reshape(mod.num_heads, 4 * mod.embed_dim).t().contiguous()
        return relation_bias.fused_relation_bias(
            box_rel_encoding(src.detach(), tgt.detach()), kernel, conv.bias, mod.embed_dim,
            mod.temperature, mod.scale)

    def check(self, label):
        from relation_detr_tpu_torch.ops import relation_bias

        launched = relation_bias.fused_relation_bias.launches - self.launches
        if self.version is not None and not launched:
            raise AssertionError(f"[{label}]: the card launched no relation_bias_rel_fwd")

    def __exit__(self, *exc):
        from relation_detr_tpu_torch.ops import relation_bias

        relation_bias.set_fused_relation(version=4)
        for mod in self.patched:
            del mod.forward
        self.patched = []


def synthetic_batch(torch, gen, bs, cap, hw, dev, valid_hw=None):
    """A batch in the loader's layout: padded canvas, mask, and GT padded to
    ``cap`` with BOXES_PER_IMAGE valid boxes (normalised cxcywh)."""
    vh, vw = valid_hw or hw
    images = torch.zeros(bs, *hw, 3, device=dev)
    images[:, :vh, :vw] = torch.randn(bs, vh, vw, 3, generator=gen, device=dev)
    mask = torch.ones(bs, *hw, dtype=torch.bool, device=dev)
    mask[:, :vh, :vw] = False
    n = BOXES_PER_IMAGE
    labels = torch.full((bs, cap), -1, dtype=torch.int64, device=dev)
    labels[:, :n] = torch.randint(0, 91, (bs, n), generator=gen, device=dev)
    boxes = torch.zeros(bs, cap, 4, device=dev)
    boxes[:, :n, :2] = torch.rand(bs, n, 2, generator=gen, device=dev) * 0.6 + 0.2
    boxes[:, :n, 2:] = torch.rand(bs, n, 2, generator=gen, device=dev) * 0.25 + 0.05
    valid = torch.zeros(bs, cap, dtype=torch.bool, device=dev)
    valid[:, :n] = True
    return {"images": images, "mask": mask, "gt_labels": labels, "gt_boxes": boxes,
            "gt_valid": valid}


def perturb_dcn(torch, model, gen):
    """Offsets of about a pixel and a half and masks away from 0.5 on every
    DCN of ``model``: at their zero initialisation every sample would sit
    on its grid point; so they are fractional and some leave the map."""
    with torch.no_grad():
        for name, param in model.named_parameters():
            if ".conv_offset." in name or ".conv_mask." in name:
                scale = 1.5 if name.endswith("bias") else 0.01
                param.add_(torch.randn(param.shape, generator=gen) * scale)


def check_tiny_train(torch, label, settings, version, family=None, n=4, backbone=None,
                     dcn=None):
    """The tiny-test config (or, with ``family``, that family's tiny model,
    ``tiny_family``) on the GPU (kernels) and the CPU (plain versions):
    one train forward + backward with the same denoising draws, run on the
    CPU as is and with the kinks pinned (``PinnedKinks``) and the GPU's
    two-stage top-k indices taken (``PinnedTopk``: a near-tie at the k-th
    proposal sends the gradient to other tokens); phase ``n``. The
    loss terms are held on both runs. The gradients: the tiny-test config's
    outside the backbone on the unpinned run too; a family's on the pinned
    run only, with the transformer's ReLUs pinned as well (a ReLU
    input within rounding of 0 moves a tiny family's encoder ``linear1``
    gradient by up to 1.3e-2 of its max; measured on the H100). With
    ``backbone`` (an arch), the tiny-test config on that backbone, held as
    a family is; ``dcn``: its ResNet's stage flags (``perturb_dcn``)."""
    from relation_detr_tpu_torch.configs import build_detector
    from relation_detr_tpu_torch.losses.criterion import relation_detr_loss
    from relation_detr_tpu_torch.ops import msda

    # a capacity-bound overflow channel jumps where a corner's side of its
    # patch's border flips between the devices (the ranks of the entries
    # after it shift): held as a family is, on the pinned run
    pin_layers = family is not None or backbone is not None or bool(
        settings.get("tiled_overflow"))
    if family is None:
        cfg = importlib.import_module(CONFIGS + "relation_detr_resnet50_tiny_test")
        args = cfg.model_args if backbone is None else dict(
            cfg.model_args, backbone_arch=backbone, backbone_stage_with_dcn=dcn)
        cpu_model = build_detector(args, "cpu", 1).train()
        criterion, num_classes, hybrid_assign = (cfg.build_criterion(), cfg.num_classes,
                                                 cfg.hybrid_assign)
    else:
        cpu_model, criterion = tiny_family(torch, family)
        cpu_model.train()
        num_classes, hybrid_assign = TINY_FAMILY["num_classes"], 6
    gen = torch.Generator().manual_seed(4)
    # Offsets on every non-backbone weight, as the CPU parity tests do. At
    # the initialisation itself the zero-initialised sampling offsets and
    # box heads put MSDA samples exactly on pixel centres, on the jump of
    # the location gradient, for every token at once. A Swin, ConvNeXt or
    # FocalNet backbone takes offsets too: at its zero-initialised biases the
    # canvas' zero padding gives exactly zero tokens, whose k in Swin v2's
    # cosine attention is 0, where the normalisation's gradient is 1/eps
    # (1e12; JAX's is NaN there) and swamps every backbone gradient.
    with torch.no_grad():
        for name, param in cpu_model.named_parameters():
            if not name.startswith("backbone.") or backbone is not None:
                param.add_(torch.randn(param.shape, generator=gen) * 0.02)
    if dcn is not None:
        perturb_dcn(torch, cpu_model, gen)
    gpu_model = copy.deepcopy(cpu_model).to("cuda")
    batch = synthetic_batch(torch, gen, 2, 16, (256, 320), "cpu")
    batch["gt_labels"][:, :BOXES_PER_IMAGE] %= num_classes
    batch["images"][1, 192:] = 0.0
    batch["mask"][1, 192:] = True
    generator = cpu_model.denoising_generator
    draws = {} if generator is None else generator.draw_noise(2, gen, "cpu")

    def run(model, dev, record=None, topk=None):
        b = {k: v.to(dev) for k, v in batch.items()}
        with TopkRecorder() if topk is None else PinnedTopk(topk) as rec, \
                PinnedKinks(model, record, pin_layers) as pins, \
                msda.msda_defaults(**settings), RelationVersion(version, cpu_model) as launched:
            outputs = model(b["images"], b["mask"], b["gt_labels"], b["gt_boxes"],
                            b["gt_valid"], train=True,
                            noise_draws={k: v.to(dev) for k, v in draws.items()} or None)
        if dev == "cuda":
            launched.check(label)
        total, losses = relation_detr_loss(criterion, outputs, b["gt_labels"],
                                           b["gt_boxes"], b["gt_valid"], hybrid_assign)
        total.backward()
        grads = {n: p.grad.cpu() for n, p in model.named_parameters() if p.grad is not None}
        model.zero_grad(set_to_none=True)
        return dict(topk=getattr(rec, "indices", None),
                    losses={k: v.item() for k, v in losses.items()},
                    total=total.item(), grads=grads, pins=pins)

    gpu = run(gpu_model, "cuda")
    cpu = run(cpu_model, "cpu")
    pinned = run(cpu_model, "cpu", record=gpu["pins"], topk=gpu["topk"])
    # Padded and invalid proposals share one score and one box, so the
    # top-k may take different members of such a tie on the two devices;
    # that changes no loss or gradient. What must agree is what was
    # selected: the class logits and boxes of the k proposals.
    flipped = []
    for name, c, g in zip(("encoder", "hybrid"), cpu["topk"], gpu["topk"]):
        for what, a, b in zip(("class logits", "boxes"), c[:2], g[:2]):
            if not torch.allclose(a, b, rtol=TOL_MODEL, atol=TOL_MODEL):
                raise AssertionError(f"tiny train step: the {name} top-k selected other "
                                     f"{what} on GPU and CPU (a near-tie flipped)")
        flipped.append(f"{name} {int((c[2] != g[2]).sum())}")

    def compare(ref, what):
        worst_loss = max(abs(gpu["losses"][k] - v) / max(abs(v), 1e-12)
                         for k, v in ref["losses"].items())
        if worst_loss > TOL_TRAIN_LOSS or set(gpu["losses"]) != set(ref["losses"]):
            raise AssertionError(f"tiny train step: loss terms differ GPU vs {what} by "
                                 f"{worst_loss}")
        if set(gpu["grads"]) != set(ref["grads"]):
            raise AssertionError(f"tiny train step: GPU and {what} differ in which leaves "
                                 "get grads")
        return worst_loss, {
            n: (gpu["grads"][n] - g).abs().max().item() / max(g.abs().max().item(), 1e-30)
            for n, g in ref["grads"].items()}

    def worst(ratios, backbone):
        keep = {n: r for n, r in ratios.items() if n.startswith("backbone.") == backbone}
        name = max(keep, key=keep.get)
        return name, keep[name], len(keep)

    loss_err, ratios = compare(cpu, "CPU")
    name, err, count = worst(ratios, backbone=False)
    if err > TOL_TRAIN_GRAD and not pin_layers:
        raise AssertionError(f"tiny train step: grad of {name} differs GPU vs CPU by "
                             f"{err:.3e} of its max")
    bb_name, bb_err, bb_count = worst(ratios, backbone=True)
    what = ("tiny-test config" if backbone is None else f"tiny-test config on {backbone}"
            f"{' with DCN' if dcn else ''}") if family is None else f"tiny {family}"
    phase(n, f"[{label}] {what} train forward + backward GPU vs CPU, same "
             f"draws: total {gpu['total']:.6f} vs {cpu['total']:.6f}, {len(cpu['losses'])} "
             f"loss terms within {loss_err:.3e} rel; {count} grads outside the backbone within "
             f"{err:.3e} of each leaf's max ({name}); {bb_count} backbone grads within "
             f"{bb_err:.3e} ({bb_name}), {'all held' if pin_layers else 'held'} below; "
             f"top-k selections equal (indices that "
             f"differ inside exact ties: {', '.join(flipped)})")
    loss_err, ratios = compare(pinned, "CPU pinned")
    name, err = max(ratios.items(), key=lambda kv: kv[1])
    if err > TOL_TRAIN_GRAD:
        raise AssertionError(f"tiny train step: grad of {name} differs GPU vs CPU with the "
                             f"kinks pinned by {err:.3e} of its max")
    _, bb_err, _ = worst(ratios, backbone=True)
    flips = pinned["pins"].flips
    phase(n, f"[{label}] the same with the CPU's kinks and top-k pinned to the GPU's "
             f"({flips['msda']} MSDA and {flips['dcn']} DCN "
             f"samples in another bilinear cell, {flips['relu']} "
             f"{'backbone and transformer' if pin_layers else 'backbone'} ReLU inputs of "
             f"another sign): total {pinned['total']:.6f}, loss terms within {loss_err:.3e} rel; "
             f"all {len(ratios)} grads within {err:.3e} of each leaf's max ({name}), backbone "
             f"within {bb_err:.3e}")


def train_steps(torch, step, batch, warmup, timed, counters, label, precision="fp32",
                title="flagship", n=6, last=None, canvas=CANVAS):
    """Runs warm-up + timed steps; checks finite losses and gradient norm
    and each counter's launches per step; prints p50, peak memory and host
    matching time (phase ``n``, the model named ``title``); ``last`` (a
    dict) takes the last step's metrics. Returns (times, peak bytes)."""
    from relation_detr_tpu_torch.losses.criterion import compute_matching

    torch.cuda.reset_peak_memory_stats()
    times, host = [], []
    for i in range(warmup + timed):
        before = {k: fn.launches for k, (fn, _) in counters.items()}
        h0 = compute_matching.host_seconds
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        metrics = step(batch)
        end.record()
        torch.cuda.synchronize()
        losses = {k: v for k, v in metrics.items() if k.startswith("loss")}
        bad = [k for k, v in losses.items() if not math.isfinite(v)]
        if bad or not math.isfinite(metrics["total_loss"]) or metrics["nonfinite_count"] or \
                not math.isfinite(metrics["grad_norm"]):
            raise AssertionError(f"train step {label} #{i}: non-finite {bad}, "
                                 f"nonfinite_count {metrics['nonfinite_count']}")
        for k, (fn, expected) in counters.items():
            if fn.launches - before[k] != expected:
                raise AssertionError(f"train step {label}: {fn.launches - before[k]} {k} "
                                     f"launches, expected {expected}")
        if i >= warmup:
            times.append(start.elapsed_time(end))
            host.append(compute_matching.host_seconds - h0)
    peak = torch.cuda.max_memory_allocated()
    phase(n, f"{title} train step {label} ({BOXES_PER_IMAGE} boxes per image) "
             f"{canvas[0]}x{canvas[1]} "
             f"{precision}: p50 {statistics.median(times):.3f} ms ({len(times)} steps: "
             f"{', '.join(f'{t:.3f}' for t in times)}); peak memory {peak / 2**30:.3f} GiB; "
             f"host matching {statistics.median(host):.4f} s/step; total_loss "
             f"{metrics['total_loss']:.4f}, grad_norm {metrics['grad_norm']:.4f}, "
             f"{len(losses)} loss terms finite")
    if last is not None:
        last.update(metrics)
    return times, peak


class Bf16Launches:
    """A wrapper's count of its bf16-value form's launches, read as
    ``launches`` (``train_steps`` reads every counter so)."""

    def __init__(self, fn):
        self.fn = fn

    @property
    def launches(self):
        return self.fn.bf16_launches

    @launches.setter
    def launches(self, value):
        self.fn.bf16_launches = value


# phase 6 under the bf16 policy: the remat policies timed (None: unset, the
# port's default, which recomputes nothing), and the runs of each
BF16_POLICIES = (None, "none", "dots", "save_all")
BF16_TRAIN_RUNS = ((1, 100, 2, 5), (2, 100, 1, 3))  # B, GT cap, warm-up, timed


def check_grads_fp32(torch, model, cfg, batch):
    """One train forward + backward outside the step: every trainable
    parameter's gradient fp32 and finite. Returns how many."""
    from relation_detr_tpu_torch.losses.criterion import relation_detr_loss

    b = batch
    outputs = model(b["images"], b["mask"], b["gt_labels"], b["gt_boxes"], b["gt_valid"],
                    train=True, generator=torch.Generator(device="cuda").manual_seed(1))
    total, _ = relation_detr_loss(cfg.build_criterion(), outputs, b["gt_labels"],
                                  b["gt_boxes"], b["gt_valid"], cfg.hybrid_assign)
    total.backward()
    grads = [(n, p.grad) for n, p in model.named_parameters() if p.requires_grad]
    bad = [n for n, g in grads if g is None or g.dtype != torch.float32
           or not bool(torch.isfinite(g).all())]
    model.zero_grad(set_to_none=True)
    if bad:
        raise AssertionError(f"bf16 train step: gradients missing, not fp32 or not finite: "
                             f"{bad[:5]}")
    return len(grads)


def run_flagship_train_bf16(torch, kernels):
    """Phase 6 under the bf16 policy: the flagship train step at B=1 (GT
    capacity 100) and B=2 under each of BF16_POLICIES, a model each (the
    same seeded weights): p50 and range, peak memory, kernel launches per
    step (18 msda_fwd, or 36 where the layers are recomputed, 18 msda_bwd,
    all of the bf16-value forms, 5 relation_bias_v4_fwd), every gradient
    fp32 and finite. The bf16 rows' launches are the unset policy's B=1 run,
    its counters set to 0 just before it."""
    from relation_detr_tpu_torch.configs import train_config
    from relation_detr_tpu_torch.ops import msda, relation_bias
    from relation_detr_tpu_torch.parallel.train_step import make_train_step
    from relation_detr_tpu_torch.utils.param_groups import build_optimizer

    cfg = importlib.import_module(CONFIGS + "relation_detr_resnet50_800_1333")
    gen = torch.Generator(device="cuda").manual_seed(15)
    smi = _run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"])
    results, last = {}, None
    for policy in BF16_POLICIES:
        model = cfg.build_model(device="cuda", seed=0, backbone_dtype="bfloat16",
                                compute_dtype="bfloat16", remat_policy=policy).train()
        optimizer = build_optimizer(model, train_config.learning_rate,
                                    weight_decay=train_config.weight_decay,
                                    betas=train_config.betas, max_norm=train_config.max_norm)
        step = make_train_step(model, cfg.build_criterion(), optimizer, cfg.hybrid_assign,
                               seed=0)
        fwd = 18 if policy in (None, "save_all") else 36
        counters = {
            "msda_fwd": (msda.multi_scale_deformable_attention, fwd),
            "msda_fwd_bf16": (Bf16Launches(msda.multi_scale_deformable_attention), fwd),
            "msda_bwd": (msda.msda_backward, 18),
            "msda_bwd_bf16": (Bf16Launches(msda.msda_backward), 18),
            "relation_bias_v4_fwd": (relation_bias.relation_bias_v4, 5),
        }
        for bs, cap, warmup, timed in BF16_TRAIN_RUNS:
            batch = synthetic_batch(torch, gen, bs, cap, CANVAS, "cuda", REQUESTS[0])
            for fn, _ in counters.values():
                fn.launches = 0
            times, peak = train_steps(torch, step, batch, warmup, timed, counters,
                                      f"[bf16, remat {policy}] B={bs} GT capacity {cap}",
                                      precision="bf16")
            if policy is None and bs == 1:
                fwd_fn, bwd_fn = msda.multi_scale_deformable_attention, msda.msda_backward
                kernels["msda_bf16"]["launches"] = fwd_fn.bf16_launches
                kernels["msda_bwd_bf16"]["launches"] = bwd_fn.bf16_launches
            results[f"{policy} B={bs}"] = dict(
                p50_ms=statistics.median(times), range_ms=[min(times), max(times)],
                peak_gib=peak / 2**30, launches_per_step={k: e for k, (_, e) in counters.items()})
        checked = check_grads_fp32(torch, model, cfg, batch)
        phase(6, f"[bf16, remat {policy}] [{smi}] launches per step: "
                 f"{', '.join(f'{k} {e}' for k, (_, e) in counters.items())}; all {checked} "
                 f"trainable gradients fp32 and finite")
        if policy is None:
            last = (model, step, synthetic_batch(torch, gen, 1, 100, CANVAS, "cuda",
                                                 REQUESTS[0]))
        del optimizer, step, model
        torch.cuda.empty_cache()
    kernels["msda_bf16"]["train"] = dict(device=smi, **results)
    return last


def run_flagship_train(torch, model, kernels):
    from relation_detr_tpu_torch.configs import train_config
    from relation_detr_tpu_torch.ops import msda, msda_tiled, patch_scatter, relation_bias
    from relation_detr_tpu_torch.parallel.train_step import make_train_step
    from relation_detr_tpu_torch.utils.param_groups import build_optimizer

    cfg = importlib.import_module(CONFIGS + "relation_detr_resnet50_800_1333")
    model.train()
    optimizer = build_optimizer(model, train_config.learning_rate,
                                weight_decay=train_config.weight_decay,
                                betas=train_config.betas, max_norm=train_config.max_norm)
    step = make_train_step(model, cfg.build_criterion(), optimizer, cfg.hybrid_assign, seed=0)
    trainable = [p for p in model.parameters() if p.requires_grad]
    frozen = [p for p in model.parameters() if not p.requires_grad]
    start_params = [p.detach().clone() for p in trainable[:: max(len(trainable) // 40, 1)]]
    frozen_sample = [p.detach().clone() for p in frozen[:5]]
    gen = torch.Generator(device="cuda").manual_seed(5)
    counters = {
        "msda_fwd": (msda.multi_scale_deformable_attention, 18),
        "msda_bwd": (msda.msda_backward, 18),
        "relation_bias_v4_fwd": (relation_bias.relation_bias_v4, 5),
        # the gather has no patch slab; msda_bwd scatters the value gradient
        "window_accumulate": (patch_scatter.window_accumulate, 0),
    }
    for fn, _ in counters.values():
        fn.launches = 0
    for bs, cap, warmup, timed in TRAIN_RUNS:
        batch = synthetic_batch(torch, gen, bs, cap, CANVAS, "cuda", REQUESTS[0])
        train_steps(torch, step, batch, warmup, timed, counters,
                    f"[gather] B={bs} GT capacity {cap}")
    per_step = ", ".join(f"{k} {e}" for k, (_, e) in counters.items())
    phase(6, f"[gather] launches per step: {per_step}")
    for key, row in (("msda_fwd", "msda"), ("msda_bwd", "msda_bwd"),
                     ("relation_bias_v4_fwd", "relation")):
        fn, _ = counters[key]
        kernels[row]["launches"] = fn.launches
        if fn.launches == 0:
            raise AssertionError(f"{key} was never launched by the train step")
    batch = synthetic_batch(torch, gen, 1, 100, CANVAS, "cuda", REQUESTS[0])

    def default_step(batch=batch):
        model.train()
        step(batch)

    PROFILES.append(("[gather] B=1 GT capacity 100 train step (in the model)", default_step,
                     ("msda_fwd_kernel", "msda_bwd_kernel", "relation_bias_v4_kernel"),
                     kernels["msda_bwd"], "in_model_train"))

    # the tiled encoder MSDA: per step and image 6 encoder layers x 4 levels
    # of tiled_core_fwd, tiled_core_bwd and window_accumulate (the patch
    # extraction's backward); the decoder and hybrid passes keep the gather
    bs, cap, warmup, timed = TILED_TRAIN_RUN
    per_image = 6 * len(LEVELS)
    counters = {
        "tiled_core_fwd": (msda_tiled.tiled_matmul_core, per_image * bs),
        "tiled_core_bwd": (msda_tiled.tiled_core_backward, per_image * bs),
        "window_accumulate": (patch_scatter.window_accumulate, per_image * bs),
        "msda_fwd": (msda.multi_scale_deformable_attention, 12),
        "msda_bwd": (msda.msda_backward, 12),
        "relation_bias_v4_fwd": (relation_bias.relation_bias_v4, 5),
    }
    batch = synthetic_batch(torch, gen, bs, cap, CANVAS, "cuda", REQUESTS[0])
    builds = patch_scatter.window_table.builds
    with msda.msda_defaults(impl="tiled"):
        for fn, _ in counters.values():
            fn.launches = 0
        train_steps(torch, step, batch, warmup, timed, counters,
                    f"[tiled] B={bs} GT capacity {cap}")
    # phase 3 made the four levels' covering-window tables on the card
    if patch_scatter.window_table.builds != builds:
        raise AssertionError(f"the tiled train step built "
                             f"{patch_scatter.window_table.builds - builds} covering-window "
                             "tables; phase 3 made all four")
    per_step = ", ".join(f"{k} {e}" for k, (_, e) in counters.items())
    phase(6, f"[tiled] launches per step: {per_step}; window_accumulate built no table and "
             "copied nothing to the card")
    for key, row in (("tiled_core_fwd", "tiled_core_fwd"), ("tiled_core_bwd", "tiled_core_bwd"),
                     ("window_accumulate", "window")):
        fn, _ = counters[key]
        kernels[row]["launches"] = fn.launches
        if fn.launches == 0:
            raise AssertionError(f"{key} was never launched by the tiled train step")

    moved = sum(not torch.equal(p.detach(), p0) for p, p0 in
                zip(trainable[:: max(len(trainable) // 40, 1)], start_params))
    if moved < len(start_params) // 2:
        raise AssertionError(f"only {moved}/{len(start_params)} sampled parameters moved")
    if not all(torch.equal(p.detach(), p0) for p, p0 in zip(frozen[:5], frozen_sample)):
        raise AssertionError("a frozen parameter moved")
    phase(6, f"{moved}/{len(start_params)} sampled trainable parameters moved, frozen "
             f"ones did not; {step.state.updates} updates, nonfinite_count "
             f"{step.state.nonfinite_count}")


def check_tiny_model(torch, label, settings, version):
    from relation_detr_tpu_torch.ops import msda

    cfg = importlib.import_module(CONFIGS + "relation_detr_resnet50_tiny_test")
    cpu_model = cfg.build_model(device="cpu", seed=1)
    gpu_model = copy.deepcopy(cpu_model).to("cuda")
    gen = torch.Generator().manual_seed(2)
    images = torch.randn(2, 256, 320, 3, generator=gen)
    mask = torch.zeros(2, 256, 320, dtype=torch.bool)
    mask[1, 192:] = True
    mask[1, :, 240:] = True
    images[mask] = 0.0
    with torch.inference_mode(), msda.msda_defaults(**settings), \
            RelationVersion(version, cpu_model) as launched:
        want = cpu_model(images, mask)
        got = gpu_model(images.cuda(), mask.cuda())
    launched.check(label)
    for name in ("pred_logits", "pred_boxes"):
        torch.testing.assert_close(got[name].cpu(), want[name], rtol=TOL_MODEL, atol=TOL_MODEL)
        err = (got[name].cpu() - want[name]).abs().max().item()
        phase(4, f"[{label}] tiny-test config GPU (kernels) vs CPU (plain) {name} "
                 f"{tuple(got[name].shape)}: max abs diff {err:.3e}")


# checks whose failure is raised at the end of the run, after every phase
# has printed its numbers (the exit code is non-zero all the same)
FAILURES = []


def heads_class(torch, got, want):
    """tests/test_model_families.py's bf16 class for two runs' heads:
    (median |dlogit| slot by slot, max |dlogit| over the sorted top-50
    logits, worst image's median distance from a box to its nearest box of
    the other run); fails beyond 0.05, 0.3, 0.02. Slot by slot is
    meaningful only where both runs decode the same proposals in the same
    slots (``PinnedTopk``): the query slot's content embedding is its own,
    whichever proposal it takes."""
    lg, lw = got["pred_logits"].float().cpu(), want["pred_logits"].float().cpu()
    median = (lg - lw).abs().median().item()
    top = (lg.reshape(-1).sort()[0][-50:] - lw.reshape(-1).sort()[0][-50:]).abs().max().item()
    bg, bw = got["pred_boxes"].float().cpu(), want["pred_boxes"].float().cpu()
    boxes = max((bg[b][:, None] - bw[b][None]).abs().amax(-1).amin(1).median().item()
                for b in range(bg.shape[0]))
    if not (median < 0.05 and top <= 0.3 and boxes < 0.02):
        raise AssertionError(f"heads outside the bf16 class: median |dlogit| {median:.4f} (< "
                             f"0.05), top-50 {top:.4f} (<= 0.3), box sets {boxes:.4f} (< 0.02)")
    return median, top, boxes


def class_numbers(torch, got, want):
    """``heads_class``'s numbers as text, in the class or not."""
    try:
        return "median |dlogit| {:.4f}, top-50 {:.4f}, box sets {:.4f}".format(
            *heads_class(torch, got, want))
    except AssertionError as exc:
        return str(exc)


# phase 4 under the bf16 policy, GPU against CPU, as tests/test_torch_bf16.py
# holds the port against JAX: the encoder's class logits before the top-k in
# bf16 units of their max (measured 1.7); after it, the CPU run takes the
# GPU run's top-k indices (``PinnedTopk``: the tiny config's 60 of ~1,300
# proposals are near-equal at its seeded weights, so any rounding reorders
# them, and its heads fall outside the bf16 class even between JAX's bf16
# and fp32 runs; unpinned, GPU vs CPU measured slot by slot median |dlogit|
# 0.10): the heads elementwise in bf16 units of their max (measured 0.7),
# the train loss total at 1% relative (measured 5e-5) and each term at 5%
# or 1e-3 (measured 1.2%: the matching still sees other costs); the
# unpinned heads' class numbers are printed beside them
TOL_BF16_PRE_TOPK_UNITS = 8
TOL_BF16_HEADS_UNITS = 4
TOL_BF16_LOSS, TOL_BF16_TERM, ATOL_BF16_TERM = 0.01, 0.05, 1e-3


def check_tiny_bf16(torch):
    """Phase 4 under the bf16 policy: the tiny-test config GPU (kernels,
    cuBLAS / cuDNN bf16) vs CPU (plain versions), same weights: the eval
    forward before the top-k, then with the CPU pinned to the GPU's top-k
    the eval heads and one train forward + backward with the same CDN
    draws; the GPU's MSDA calls take the bf16-value forms and every
    gradient is fp32 and finite."""
    from relation_detr_tpu_torch.losses.criterion import relation_detr_loss
    from relation_detr_tpu_torch.ops import msda

    cfg = importlib.import_module(CONFIGS + "relation_detr_resnet50_tiny_test")
    cpu_model = cfg.build_model(device="cpu", seed=1, backbone_dtype="bfloat16",
                                compute_dtype="bfloat16")
    gen = torch.Generator().manual_seed(4)
    with torch.no_grad():
        for name, param in cpu_model.named_parameters():
            if not name.startswith("backbone."):
                param.add_(torch.randn(param.shape, generator=gen) * 0.02)
    gpu_model = copy.deepcopy(cpu_model).to("cuda")
    batch = synthetic_batch(torch, gen, 2, 16, (256, 320), "cpu")
    batch["gt_labels"][:, :BOXES_PER_IMAGE] %= cfg.num_classes
    batch["images"][1, 192:] = 0.0
    batch["mask"][1, 192:] = True
    draws = cpu_model.denoising_generator.draw_noise(2, gen, "cpu")

    def run(model, dev, pinned=None):
        """``pinned``: the GPU run's top-k indices (the eval forward's, then
        the train forward's encoder and hybrid ones)."""
        b = {k: v.to(dev) for k, v in batch.items()}
        pre = {}
        hook = model.transformer.encoder_class_head.register_forward_hook(
            lambda mod, a, out: pre.__setitem__("enc", out.detach().float().cpu()))
        model.eval()
        with torch.no_grad():
            free = model(b["images"], b["mask"])
        hook.remove()
        with TopkRecorder() if pinned is None else PinnedTopk(pinned) as rec:
            with torch.no_grad():
                heads = model(b["images"], b["mask"])
            model.train()
            outputs = model(b["images"], b["mask"], b["gt_labels"], b["gt_boxes"],
                            b["gt_valid"], train=True,
                            noise_draws={k: v.to(dev) for k, v in draws.items()})
        total, losses = relation_detr_loss(cfg.build_criterion(), outputs, b["gt_labels"],
                                           b["gt_boxes"], b["gt_valid"], cfg.hybrid_assign)
        total.backward()
        grads = {n: p.grad for n, p in model.named_parameters() if p.grad is not None}
        bad = [n for n, g in grads.items() if g.dtype != torch.float32
               or not bool(torch.isfinite(g).all())]
        model.zero_grad(set_to_none=True)
        model.eval()
        return dict(pre=pre["enc"], free=free, heads=heads, total=total.item(), bad=bad,
                    n=len(grads), losses={k: v.item() for k, v in losses.items()},
                    topk=rec.indices if pinned is None else None)

    launched = msda.multi_scale_deformable_attention.bf16_launches
    launched_bwd = msda.msda_backward.bf16_launches
    gpu = run(gpu_model, "cuda")
    if msda.multi_scale_deformable_attention.bf16_launches == launched or \
            msda.msda_backward.bf16_launches == launched_bwd:
        raise AssertionError("[bf16] the tiny config on the card launched no bf16 MSDA form")
    cpu = run(cpu_model, "cpu", pinned=gpu["topk"])

    def units(a, b):
        a, b = a.float().cpu(), b.float().cpu()
        return (a - b).abs().max().item() / (BF16_EPS * b.abs().max().item())

    pre_units = units(gpu["pre"], cpu["pre"])
    if pre_units > TOL_BF16_PRE_TOPK_UNITS:
        raise AssertionError(f"[bf16] tiny config: encoder class logits before the top-k "
                             f"{pre_units:.2f} bf16 units apart GPU vs CPU (> "
                             f"{TOL_BF16_PRE_TOPK_UNITS})")
    head_units = {k: units(gpu["heads"][k], cpu["heads"][k])
                  for k in ("pred_logits", "pred_boxes")}
    if max(head_units.values()) > TOL_BF16_HEADS_UNITS:
        FAILURES.append(f"phase 4 [bf16]: heads on the same top-k {head_units} bf16 units "
                        f"apart GPU vs CPU (> {TOL_BF16_HEADS_UNITS})")
    free = class_numbers(torch, gpu["free"], cpu["free"])
    if gpu["bad"] or cpu["bad"] or gpu["n"] != cpu["n"]:
        raise AssertionError(f"[bf16] tiny train step: gradients not fp32 and finite: GPU "
                             f"{gpu['bad'][:5]}, CPU {cpu['bad'][:5]}")
    worst = {}
    for k, want in cpu["losses"].items():
        diff = abs(gpu["losses"][k] - want)
        worst[k] = diff / max(abs(want), 1e-12)
        if diff > ATOL_BF16_TERM + TOL_BF16_TERM * abs(want):
            FAILURES.append(f"phase 4 [bf16]: tiny train step {k} {gpu['losses'][k]} on the "
                            f"GPU, {want} on the CPU")
    total_rel = abs(gpu["total"] - cpu["total"]) / abs(cpu["total"])
    if total_rel > TOL_BF16_LOSS:
        FAILURES.append(f"phase 4 [bf16]: tiny train step total {gpu['total']} vs "
                        f"{cpu['total']}")
    name = max(worst, key=worst.get)
    phase(4, f"[bf16] tiny-test config GPU (kernels, bf16 forms) vs CPU (plain): encoder class "
             f"logits before the top-k {pre_units:.3f} bf16 units of their max apart; on the "
             f"GPU's top-k: heads {head_units['pred_logits']:.3f} (logits) and "
             f"{head_units['pred_boxes']:.3f} (boxes) bf16 units apart; train forward + "
             f"backward, same draws: total {gpu['total']:.6f} vs {cpu['total']:.6f} "
             f"({total_rel:.3e} rel), worst term {name} {worst[name]:.3e} rel; all {gpu['n']} "
             f"gradients fp32 and finite on both; unpinned heads (each run's own top-k): "
             f"{free}")


def run_flagship(torch, kernels):
    from relation_detr_tpu_torch.inference import detect
    from relation_detr_tpu_torch.ops import msda, relation_bias

    cfg = importlib.import_module(CONFIGS + "relation_detr_resnet50_800_1333")
    t0 = time.perf_counter()
    model = cfg.build_model(device="cuda", seed=0)
    phase(5, f"flagship model built on cuda in {time.perf_counter() - t0:.1f} s "
             f"({sum(p.numel() for p in model.parameters())} parameters)")
    gen = torch.Generator(device="cuda").manual_seed(3)

    def request(h, w):
        images = torch.zeros(1, *CANVAS, 3, device="cuda")
        images[0, :h, :w] = torch.randn(h, w, 3, generator=gen, device="cuda")
        mask = torch.ones(1, *CANVAS, dtype=torch.bool, device="cuda")
        mask[0, :h, :w] = False
        return images, mask, [[h, w]]

    raw = {}  # the model's raw heads, captured inside detect() by a hook
    hook = model.register_forward_hook(lambda module, args, out: raw.update(out))
    torch.cuda.reset_peak_memory_stats()
    msda.multi_scale_deformable_attention.launches = 0
    relation_bias.relation_bias_v4.launches = 0
    for i, (h, w) in enumerate(REQUESTS):
        m0 = msda.multi_scale_deformable_attention.launches
        r0 = relation_bias.relation_bias_v4.launches
        images, mask, sizes = request(h, w)
        det = detect(model, images, mask, sizes, 100)
        torch.cuda.synchronize()
        dm = msda.multi_scale_deformable_attention.launches - m0
        dr = relation_bias.relation_bias_v4.launches - r0
        if dm != 12 or dr != 5:
            raise AssertionError(f"request {i}: {dm} MSDA / {dr} relation launches, "
                                 "expected 12 / 5")
        logits, boxes = raw["pred_logits"], raw["pred_boxes"]
        if logits.shape != (1, 900, 91) or boxes.shape != (1, 900, 4):
            raise AssertionError(f"request {i}: bad output shapes")
        if det["boxes"].shape != (1, 100, 4) or det["scores"].shape != (1, 100):
            raise AssertionError(f"request {i}: expected 100 detections")
        for t in (logits, boxes, det["scores"], det["boxes"]):
            if not bool(torch.isfinite(t).all()):
                raise AssertionError(f"request {i}: non-finite outputs")
        phase(5, f"request {i} valid {h}x{w} on {CANVAS[0]}x{CANVAS[1]}: logits "
                 f"{tuple(logits.shape)}, boxes {tuple(boxes.shape)}, 100 detections, "
                 f"all finite, {dm} MSDA + {dr} relation-bias launches, "
                 f"top score {det['scores'][0, 0].item():.4f}")
    kernels["msda"]["eval_launches"] = msda.multi_scale_deformable_attention.launches
    kernels["relation"]["eval_launches"] = relation_bias.relation_bias_v4.launches
    for row in (kernels["msda"], kernels["relation"]):
        if row["eval_launches"] == 0:
            raise AssertionError(f"{row['name']} was never launched on the eval path")
    peak = torch.cuda.max_memory_allocated()

    images, mask, sizes = request(*REQUESTS[0])
    times = timed_detects(torch, detect, model, images, mask, sizes)
    phase(5, f"flagship B=1 800x1344 fp32 detect: p50 {statistics.median(times):.3f} ms "
             f"({len(times)} runs: {', '.join(f'{t:.3f}' for t in times)}), peak memory "
             f"{peak / 2**30:.3f} GiB (max_memory_allocated over the 4 requests)")

    def one_detect():
        model.eval()
        detect(model, images, mask, sizes, 100)

    PROFILES.append(("flagship B=1 detect (in the model)", one_detect,
                     ("msda_fwd_kernel", "relation_bias_v4_kernel", "Memcpy"), kernels["msda"],
                     "in_model_eval"))
    run_flagship_variants(torch, model, raw, request, kernels)
    hook.remove()
    return model, run_flagship_bf16(torch, model, request, times, peak, kernels)


def timed_detects(torch, detect, model, images, mask, sizes):
    """DETECT_RUNS detects after one warm-up, each timed by CUDA events."""
    detect(model, images, mask, sizes, 100)
    times = []
    for _ in range(DETECT_RUNS):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        detect(model, images, mask, sizes, 100)
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return times


def run_flagship_bf16(torch, model32, request, times32, peak32, kernels):
    """Phase 5 under the bf16 policy: the flagship with the fp32 model's
    weights (the same seed) and compute_dtype = backbone_dtype = bf16
    answers the fp32 p50's request with 12 msda_fwd launches, all of the
    bf16-value form, and 5 relation_bias_v4_fwd, its heads and detections
    fp32 and finite; its encoder class logits before the top-k against
    fp32's in bf16 units; on the fp32 run's top-k (``PinnedTopk``) its heads
    in the bf16 class (``heads_class``), and on its own top-k the class's
    numbers printed; then its p50 and peak memory beside the fp32 detect's.
    Returns the model (phase 10 profiles it)."""
    from relation_detr_tpu_torch.inference import detect
    from relation_detr_tpu_torch.ops import msda, relation_bias

    cfg = importlib.import_module(CONFIGS + "relation_detr_resnet50_800_1333")
    model = cfg.build_model(device="cuda", seed=0, backbone_dtype="bfloat16",
                            compute_dtype="bfloat16")
    images, mask, sizes = request(*REQUESTS[0])
    raw, pre = {}, {}
    hooks = []
    for name, m in (("fp32", model32), ("bf16", model)):
        hooks.append(m.register_forward_hook(
            lambda mod, a, out, name=name: raw.__setitem__(name, out)))
        hooks.append(m.transformer.encoder_class_head.register_forward_hook(
            lambda mod, a, out, name=name: pre.__setitem__(name, out.float())))
    with TopkRecorder() as rec:
        detect(model32, images, mask, sizes, 100)
    with PinnedTopk(rec.indices):
        detect(model, images, mask, sizes, 100)
    pinned = raw["bf16"]
    torch.cuda.reset_peak_memory_stats()
    fn = msda.multi_scale_deformable_attention
    fn.launches = fn.bf16_launches = relation_bias.relation_bias_v4.launches = 0
    det = detect(model, images, mask, sizes, 100)
    torch.cuda.synchronize()
    launches = (fn.launches, fn.bf16_launches, relation_bias.relation_bias_v4.launches)
    for h in hooks:
        h.remove()
    if launches != (12, 12, 5):
        raise AssertionError(f"bf16 detect: (msda_fwd, of which bf16 form, relation) launches "
                             f"{launches}, expected (12, 12, 5)")
    kernels["msda_bf16"]["eval_launches"] = fn.bf16_launches
    heads = raw["bf16"]
    for t in (heads["pred_logits"], heads["pred_boxes"], det["scores"], det["boxes"]):
        if t.dtype != torch.float32 or not bool(torch.isfinite(t).all()):
            raise AssertionError("bf16 detect: heads or detections not fp32 and finite")
    try:
        median, top, boxes = heads_class(torch, pinned, raw["fp32"])
    except AssertionError as exc:  # raised at the end of the run
        FAILURES.append(f"phase 5, bf16 detect against the fp32 detect on its top-k: {exc}")
        median = top = boxes = float("nan")
    free = class_numbers(torch, heads, raw["fp32"])
    units = ((pre["bf16"] - pre["fp32"]).abs().max() /
             (BF16_EPS * pre["fp32"].abs().max())).item()
    times = timed_detects(torch, detect, model, images, mask, sizes)
    peak = torch.cuda.max_memory_allocated()
    smi = _run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"])
    phase(5, f"flagship B=1 800x1344 bf16 detect (compute_dtype = backbone_dtype = bf16) "
             f"[{smi}]: p50 {statistics.median(times):.3f} ms (range {min(times):.3f}-"
             f"{max(times):.3f}; {len(times)} runs) against the fp32 detect's "
             f"{statistics.median(times32):.3f} ms (range {min(times32):.3f}-"
             f"{max(times32):.3f}); peak memory {peak / 2**30:.3f} GiB against "
             f"{peak32 / 2**30:.3f}; launches per forward: 12 msda_fwd (bf16-value form), 5 "
             f"relation_bias_v4_fwd; encoder class logits before the top-k {units:.2f} bf16 "
             f"units of their max from fp32's; heads on the fp32 run's top-k in the bf16 "
             f"class: median |dlogit| {median:.4f}, top-50 {top:.4f}, box sets {boxes:.4f}; "
             f"on its own top-k: {free}")
    kernels["msda_bf16"]["detect"] = dict(
        p50_ms=statistics.median(times), range_ms=[min(times), max(times)], peak_gib=peak / 2**30,
        fp32_p50_ms=statistics.median(times32), fp32_range_ms=[min(times32), max(times32)],
        fp32_peak_gib=peak32 / 2**30, heads_class_pinned=[median, top, boxes],
        heads_own_topk=free, pre_topk_bf16_units=units, device=smi)
    return model


RELATION_PROFILE_RETRIES = 4  # profiles taken again while one sees no device work


def check_relation_calls(torch, model, kernels):
    """The flagship decoder's relation module on 900 boxes, 5 calls in
    inference mode under torch.profiler: its only device work must be
    relation_bias_v4_fwd (no copy, no feature op), launched once a call
    (the wrapper's count)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from relation_detr_tpu_torch.ops.relation_bias import relation_bias_v4

    module = model.transformer.decoder.position_relation_embedding
    gen = torch.Generator(device="cuda").manual_seed(4)
    src, tgt = (torch.rand(1, 900, 4, generator=gen, device="cuda") * 0.5 + 0.01
                for _ in range(2))

    def five_calls():
        with torch.inference_mode():
            launches = relation_bias_v4.launches
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                for _ in range(5):
                    module(src, tgt)
                torch.cuda.synchronize()
        # device work: kernels, copies and fills (profiler bookkeeping aside)
        return relation_bias_v4.launches - launches, {
            e.key: e.count for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and "Activity Buffer" not in e.key}

    with torch.inference_mode():
        module(src, tgt)
        torch.cuda.synchronize()
    launches, device = five_calls()
    for _ in range(RELATION_PROFILE_RETRIES):
        if device:
            break
        # a session now and then sees no device activity at all (twice in
        # a row after the train CLI's own profile, on the H100)
        launches, device = five_calls()
    phase(10, f"5 relation-bias calls of the flagship decoder (N = 900): {launches} "
             f"relation_bias_v4_fwd launches, device work {device}")
    kernels["relation"]["device_work_5_calls"] = device
    if launches != 5 or not device or any("relation_bias_v4_kernel" not in k for k in device):
        raise AssertionError(f"relation bias: expected one relation_bias_v4_fwd launch per "
                             f"call and no other device work, got {launches} launches and "
                             f"{device}")


def check_eval_forward_busy(torch, model):
    """Phase 9: the split's first B=2 batch (decoded on the card) through
    ``make_detections_fn`` on phase 5's flagship model: the forward's span
    on the stream (CUDA events, as the eval CLI's "forward" stage; median
    of 5 after one), its device-busy time in one call (torch.profiler: every
    kernel, copy and fill) and the share of the span the card idles."""
    import statistics as stats_

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from relation_detr_tpu_torch.data.coco import CocoDetection
    from relation_detr_tpu_torch.data.loader import DataLoader
    from relation_detr_tpu_torch.data.transforms import EvalPreset
    from relation_detr_tpu_torch.utils.evaluation import make_detections_fn, upload

    coco = os.path.join(ROOT, EVAL_DATA, "synth_coco")
    dataset = CocoDetection(os.path.join(coco, "val2017"),
                            os.path.join(coco, "annotations", "instances_val2017.json"),
                            EvalPreset(800, 1333, normalize_host=False), device="cuda")
    batches = iter(DataLoader(dataset, batch_size=EVAL_BATCH))
    batch = next(batches)
    batches.close()
    det_fn = make_detections_fn(model, 300)
    inputs = upload(batch, torch.device("cuda"))
    spans = []
    for _ in range(6):
        torch.cuda.synchronize()
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        det_fn(*inputs)
        end.record()
        end.synchronize()
        spans.append(start.elapsed_time(end))
    span = stats_.median(spans[1:])

    def busy_ms():
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            det_fn(*inputs)
            torch.cuda.synchronize()
        return sum(e.self_device_time_total for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA and "Activity Buffer" not in e.key) / 1e3

    busy = busy_ms() or busy_ms()  # a session now and then sees no device time
    canvas = tuple(batch["images"].shape[1:3])
    idle = 1 - busy / span if busy else None
    phase(10, f"flagship eval forward B={EVAL_BATCH} on {canvas} (make_detections_fn): span on "
             f"the stream {span:.3f} ms (CUDA events, median of 5), device busy {busy:.3f} ms "
             f"(torch.profiler), idle share of the span "
             f"{'not measured' if idle is None else f'{idle:.4f}'}")
    return dict(canvas=canvas, span_ms=span, busy_ms=busy, idle_share=idle)


def jpeg_decoders():
    """Which JPEG decoders the machine has, for the folder CLI's image decode
    (informational: never raises)."""
    import ctypes.util
    import glob

    try:
        cuda = os.environ.get("CUDA_HOME", "/usr/local/cuda")

        def first(patterns):
            hits = [h for pat in patterns for h in sorted(glob.glob(pat))]
            return hits[0] if hits else None

        found = {
            "nvjpeg.h": first([f"{cuda}/include/nvjpeg.h",
                               f"{cuda}/targets/*/include/nvjpeg.h", "/usr/include/nvjpeg.h"]),
            "libnvjpeg.so": first([f"{cuda}/lib64/libnvjpeg.so*",
                                   f"{cuda}/targets/*/lib/libnvjpeg.so*"]),
            "jpeglib.h": first(["/usr/include/jpeglib.h", "/usr/include/*/jpeglib.h",
                                "/usr/local/include/jpeglib.h"]),
            "libjpeg.so": ctypes.util.find_library("jpeg") or first(
                ["/usr/lib/*/libjpeg.so*", "/usr/lib/libjpeg.so*", "/usr/local/lib/libjpeg.so*"]),
        }
        return "; ".join(f"{k} {v or 'absent'}" for k, v in found.items())
    except Exception as exc:  # informational only
        return f"not checked ({exc!r})"


def run_flagship_variants(torch, model, raw, request, kernels):
    """The flagship detect under each of EVAL_VARIANTS against the default
    (gather MSDA, relation v4) on the same weights and the full-canvas
    request (valid ratios 1, so every encoder sample at the seeded init
    lies inside the auto halos): pre-top-k heads, launches per forward, p50
    and peak memory of each."""
    from relation_detr_tpu_torch.inference import detect
    from relation_detr_tpu_torch.ops import msda, msda_tiled, relation_bias

    images, mask, sizes = request(*REQUESTS[3])
    counted = {
        "msda_fwd": msda.multi_scale_deformable_attention,
        "relation_bias_v4_fwd": relation_bias.relation_bias_v4,
        "tiled_core_fwd": msda_tiled.tiled_matmul_core,
        "sep_contract_fwd": msda_tiled.sep_contract_fused,
        "relation_bias_rel_fwd": relation_bias.fused_relation_bias,
    }
    expected = {
        "default": dict(msda_fwd=12, relation_bias_v4_fwd=5),
        "tiled": dict(msda_fwd=6, relation_bias_v4_fwd=5, tiled_core_fwd=24),
        "tiled_xla + tiled_sep_kernel": dict(msda_fwd=6, relation_bias_v4_fwd=5,
                                             sep_contract_fwd=24),
        "relation v1": dict(msda_fwd=12, relation_bias_rel_fwd=5),
        "relation v2": dict(msda_fwd=12, relation_bias_rel_fwd=5),
    }
    found = {}
    for label, settings, version, tol in (("default", {}, None, 0.0),) + EVAL_VARIANTS:
        with msda.msda_defaults(**settings):
            if version is not None:
                relation_bias.set_fused_relation(version=version)
            try:
                torch.cuda.reset_peak_memory_stats()
                for fn in counted.values():
                    fn.launches = 0
                with TopkRecorder() as rec:
                    det = detect(model, images, mask, sizes, 100)
                torch.cuda.synchronize()
                launches = {k: fn.launches for k, fn in counted.items()}
                heads = {k: raw[k].clone() for k in ("pred_logits", "pred_boxes")}
                peak = torch.cuda.max_memory_allocated()
                times = []
                for _ in range(5):
                    start = torch.cuda.Event(enable_timing=True)
                    end = torch.cuda.Event(enable_timing=True)
                    start.record()
                    detect(model, images, mask, sizes, 100)
                    end.record()
                    torch.cuda.synchronize()
                    times.append(start.elapsed_time(end))
            finally:
                relation_bias.set_fused_relation(version=4)
        want = expected[label]
        got = {k: v for k, v in launches.items() if v or k in want}
        if got != want:
            raise AssertionError(f"detect [{label}]: launches per forward {got}, expected {want}")
        if not all(bool(torch.isfinite(t).all()) for t in (*heads.values(), det["scores"])):
            raise AssertionError(f"detect [{label}]: non-finite outputs")
        found[label] = dict(heads=heads, topk=rec.indices[0][2], launches=launches,
                            proposals=rec.candidates[0])
        msg = ""
        if label != "default":
            base = found["default"]
            # before the top-k: the encoder's class logits and boxes of every
            # proposal (invalid ones are +inf boxes on both sides)
            pre = []
            for a, b in zip(rec.candidates[0], base["proposals"]):
                finite = torch.isfinite(b)
                if not torch.equal(finite, torch.isfinite(a)):
                    raise AssertionError(f"detect [{label}]: other proposals are invalid")
                pre.append((a[finite] - b[finite]).abs().max().item())
            if not (max(pre) <= tol):
                raise AssertionError(f"detect [{label}] vs default: pre-top-k class logits / "
                                     f"boxes differ by {pre} > {tol}")
            flipped = int((rec.indices[0][2] != base["topk"]).sum())
            errs = {k: (heads[k] - base["heads"][k]).abs().max().item() for k in heads}
            if flipped == 0 and not (max(errs.values()) <= max(tol, TOL_TILED_EVAL)):
                raise AssertionError(f"detect [{label}] vs default: same top-k, heads differ "
                                     f"by {errs}")
            msg = (f"pre-top-k vs default over {base['proposals'][0].shape[1]} proposals: class "
                   f"logits {pre[0]:.3e}, boxes {pre[1]:.3e} (tolerance {tol:g}); encoder "
                   f"top-900 indices that differ: {flipped}; heads after it: pred_logits "
                   f"{errs['pred_logits']:.3e}, pred_boxes {errs['pred_boxes']:.3e}; ")
        phase(5, f"flagship B=1 800x1344 (valid 800x1344) detect [{label}]: {msg}launches per "
                 f"forward {got}; p50 {statistics.median(times):.3f} ms (5 runs: "
                 f"{', '.join(f'{t:.3f}' for t in times)}), peak memory {peak / 2**30:.3f} GiB")

    def sep_detect():
        with msda.msda_defaults(impl="tiled_xla", tiled_sep_kernel=True):
            detect(model, images, mask, sizes, 100)

    def tiled_detect():
        with msda.msda_defaults(impl="tiled"):
            detect(model, images, mask, sizes, 100)

    def v1_detect():
        relation_bias.set_fused_relation(version=1)
        try:
            detect(model, images, mask, sizes, 100)
        finally:
            relation_bias.set_fused_relation(version=4)

    PROFILES.append(("flagship B=1 detect [tiled_xla + tiled_sep_kernel] (in the model)",
                     sep_detect, ("sep_contract_fwd_kernel",), kernels["sep_contract_fwd"],
                     "in_model_eval"))
    PROFILES.append(("flagship B=1 detect [tiled] (in the model)", tiled_detect,
                     ("tiled_core_fwd_kernel",), kernels["tiled_core_fwd"], "in_model_eval"))
    PROFILES.append(("flagship B=1 detect [relation v1] (in the model)", v1_detect,
                     ("relation_bias_rel_kernel",), kernels["relation_rel"], "in_model_eval"))
    kernels["tiled_core_fwd"]["eval_launches"] = found["tiled"]["launches"]["tiled_core_fwd"]
    kernels["sep_contract_fwd"]["launches"] = \
        found["tiled_xla + tiled_sep_kernel"]["launches"]["sep_contract_fwd"]
    kernels["relation_rel"]["launches"] = sum(
        found[k]["launches"]["relation_bias_rel_fwd"] for k in ("relation v1", "relation v2"))


def canvas_levels(canvas):
    """The 4 feature levels of a canvas: strides 8, 16, 32 and 64, each
    level ceil(half) of the one before (the backbone's and the neck's
    stride-2 convolutions)."""
    h, w = -(-canvas[0] // 8), -(-canvas[1] // 8)
    levels = [(h, w)]
    for _ in range(3):
        h, w = -(-h // 2), -(-w // 2)
        levels.append((h, w))
    return tuple(levels)


def eval_canvases():
    """The canvases phase 7's eval CLI batches the committed split into:
    its loader's batches (B=EVAL_BATCH, in order), each image at the
    flagship eval preset's size from its annotated one, the batch's canvas
    by the loader's ``pick_canvas``; with PORTRAIT_CANVAS. Sorted."""
    from relation_detr_tpu_torch import test as eval_cli
    from relation_detr_tpu_torch.data.coco import CocoDetection
    from relation_detr_tpu_torch.data.loader import DataLoader, pick_canvas
    from relation_detr_tpu_torch.data.transforms import shortest_side_size
    from relation_detr_tpu_torch.utils.config import Config

    cfg = Config(eval_cli.DEFAULT_CONFIG)
    coco = os.path.join(ROOT, EVAL_DATA, "synth_coco")
    dataset = CocoDetection(os.path.join(coco, "val2017"),
                            os.path.join(coco, "annotations", "instances_val2017.json"))
    loader = DataLoader(dataset, batch_size=EVAL_BATCH, shuffle=False)
    canvases = {PORTRAIT_CANVAS}
    for indices in loader._batches():
        sizes = [shortest_side_size(dataset.images[dataset.ids[i]]["height"],
                                    dataset.images[dataset.ids[i]]["width"],
                                    cfg.get("min_size", 800), cfg.get("max_size", 1333))
                 for i in indices]
        canvases.add(pick_canvas(max(h for h, _ in sizes), max(w for _, w in sizes),
                                 loader.buckets))
    return sorted(canvases)


def check_eval_shapes(torch, rows):
    """msda_fwd at B=2 on the levels of every canvas of ``eval_canvases``
    (the encoder, Q = S, and the decoder, Q = 900, encoder-like set) and
    relation_bias_v4_fwd at B=2, N = 900: the shapes of the evaluation
    path's batches, against the plain versions and timed in turns with
    them. Stores the canvases at rows["msda"]["eval_canvases"]."""
    from relation_detr_tpu_torch.ops import msda, relation_bias

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(8)
    canvases = eval_canvases()
    rows["msda"]["eval_canvases"] = canvases
    for canvas in canvases:
        levels = canvas_levels(canvas)
        total = sum(h * w for h, w in levels)
        for nq in (total, 900):
            value, locs, attn = msda_encoder_inputs(torch, gen, nq, dev, levels, EVAL_BATCH)
            with torch.no_grad():
                got = msda.multi_scale_deformable_attention(value, levels, locs, attn)
                want = msda.msda_reference(value, levels, locs, attn)
                torch.cuda.synchronize()
                err = (got - want).abs().max().item()
                shape = f"B={EVAL_BATCH} Q={nq} levels {levels}"
                if not (err <= TOL_KERNEL):
                    raise AssertionError(f"msda_fwd {shape}: max abs err {err} > {TOL_KERNEL}")
                ms, plain_ms = in_turns(
                    lambda: msda.msda_reference(value, levels, locs, attn),
                    lambda: msda.multi_scale_deformable_attention(value, levels, locs, attn),
                    5, 20)
            fb = bound(msda_value_bytes(torch, value, levels, locs) + size(locs, attn, got),
                       10 * got.numel() * 16)
            rows["msda"]["shapes_ms"][f"B={EVAL_BATCH} Q={nq} {canvas} encoder-like"] = \
                [ms, plain_ms, fb[0]]
            rows["msda"]["max_abs_err"] = max(rows["msda"]["max_abs_err"], err)
            phase(3, f"msda_fwd {shape}, encoder-like: max_abs_err {err:.3e}, kernel "
                     f"{ms:.4f} ms, plain {plain_ms:.4f} ms, bound {fb[0]:.4f} ms ({fb[1]})")
            del value, locs, attn, got, want

    src, tgt, kernel, bias = relation_inputs(torch, gen, 900, dev, EVAL_BATCH)
    with torch.no_grad():
        got = relation_bias.relation_bias_v4(src, tgt, kernel, bias)
        want = relation_bias.relation_bias_v4_reference(src, tgt, kernel, bias)
        torch.cuda.synchronize()
        if not bool(torch.isfinite(got).all()) or not bool(torch.isfinite(want).all()):
            raise AssertionError("relation bias B=2: the clamped NaN/Inf boxes must give "
                                 "finite biases in kernel and plain version")
        err = (got - want).abs().max().item()
        if not (err <= TOL_KERNEL):
            raise AssertionError(f"relation bias B=2: max abs err {err} > {TOL_KERNEL}")
        ms, plain_ms = in_turns(
            lambda: relation_bias.relation_bias_v4_reference(src, tgt, kernel, bias),
            lambda: relation_bias.relation_bias_v4(src, tgt, kernel, bias), 10, 50)
    v4_bound = relation_v4_bound(src, tgt, kernel, bias, got)
    rows["relation"]["b2_ms"] = [ms, plain_ms, v4_bound[0]]
    rows["relation"]["max_abs_err"] = max(rows["relation"]["max_abs_err"], err)
    phase(3, f"relation_bias_v4_fwd B={EVAL_BATCH} N1=N2=900 H=8: max_abs_err {err:.3e}, "
             f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, bound {v4_bound[0]:.4f} ms "
             f"({v4_bound[1]})")


def check_ycc_kernel(torch, rows):
    """ycc_to_rgb (the decoder's chroma upsampling and colour conversion)
    against its plain version on nvJPEG's planes of the split's largest
    JPEG (4:2:0), bit for bit, timed in turns; and the whole decode of that
    file (host clock)."""
    import numpy as np

    from relation_detr_tpu_torch.data import image_io

    folder = os.path.join(ROOT, EVAL_DATA, "synth_coco", "val2017")
    path = max((os.path.join(folder, f) for f in os.listdir(folder)), key=os.path.getsize)
    data = np.fromfile(path, np.uint8)
    decoder = image_io.nvjpeg_decoder(0)
    *planes, factors = decoder.planes(data, path)
    y, cb = planes[:2]
    got = image_io.ycc_to_rgb(*planes, *factors)
    want = image_io.ycc_to_rgb_reference(*planes, *factors)
    torch.cuda.synchronize()
    err = (got.int() - want.int()).abs().max().item()
    if err != 0:
        raise AssertionError(f"ycc_to_rgb: max abs err {err} levels, expected bit-identical")
    ms, plain_ms = in_turns(lambda: image_io.ycc_to_rgb_reference(*planes, *factors),
                            lambda: image_io.ycc_to_rgb(*planes, *factors), 10, 50)
    fb = bound(size(*planes, got), 0)  # a few integer operations a byte
    decoder.decode(data, path)
    t0 = time.perf_counter()
    for _ in range(20):
        decoder.decode(data, path)
    decode_ms = (time.perf_counter() - t0) / 20 * 1e3
    shape = f"{y.shape[0]}x{y.shape[1]}, chroma {cb.shape[0]}x{cb.shape[1]} ({factors})"
    phase(3, f"ycc_to_rgb {shape}: bit-identical to its plain version, kernel {ms:.4f} ms, "
             f"plain {plain_ms:.4f} ms, bound {fb[0]:.4f} ms ({fb[1]}); the whole nvJPEG "
             f"decode of {os.path.basename(path)} {decode_ms:.3f} ms (host clock, one thread)")
    rows["ycc_to_rgb"] = dict(
        name="ycc_to_rgb", route="cuda", source="relation_detr_tpu_torch/csrc/jpeg_decode.cu",
        replaces="relation_detr_tpu/data/coco.py:134", max_abs_err=float(err), ms=ms,
        plain_ms=plain_ms, bound_ms=fb[0], bound_by=fb[1], library_ms=None,
        library="none: no one call upsamples chroma as libjpeg does", shape=shape,
        decode_ms=decode_ms,
        note="the decoder's chroma upsampling and colour conversion (cv2.imdecode's in the "
             "JAX package; not a TPU kernel)")


def check_decode():
    """Phase 7 (a): nvJPEG on the card against cv2's decode of each fixture
    (shapes exact, mean |difference| within TOL_DECODE_MEAN, one
    ``ycc_to_rgb`` launch a YCbCr or YCCK file), and the split's JPEGs at their annotated sizes. Returns {fixture: [max, mean,
    share more than 8 levels off]}."""
    import numpy as np

    from relation_detr_tpu_torch.data import image_io

    folder = os.path.join(ROOT, EVAL_DATA)
    found = {}
    tol = TOL_DECODE_MEAN
    for name in DECODE_FIXTURES:
        launches = image_io.ycc_to_rgb.launches
        got = image_io.read_image(os.path.join(folder, name + ".jpg"))
        launches = image_io.ycc_to_rgb.launches - launches
        want = np.load(os.path.join(folder, name + ".npy"))
        if got.shape != want.shape or got.dtype != np.uint8:
            raise AssertionError(f"decode {name}: {got.shape} {got.dtype}, cv2 {want.shape}")
        if launches != (name not in ("decode_gray", "decode_cmyk")):
            raise AssertionError(f"decode {name}: {launches} ycc_to_rgb launches, expected one "
                                 "for a YCbCr or YCCK file, none for grey or CMYK")
        diff = np.abs(got.astype(np.int16) - want.astype(np.int16))
        found[name] = [int(diff.max()), float(diff.mean()), float((diff > 8).mean())]
        phase(7, f"decode {name}.jpg {got.shape}: |nvJPEG - cv2| max {diff.max()}, mean "
                 f"{diff.mean():.4f} (tolerance {tol}), share > 8 levels off "
                 f"{(diff > 8).mean():.4f}; {launches} ycc_to_rgb launches")
        if not (diff.mean() <= tol):
            raise AssertionError(f"decode {name}: mean |diff| {diff.mean()} > {tol}")
    with open(os.path.join(folder, "synth_coco", "annotations", "instances_val2017.json")) as f:
        images = json.load(f)["images"]
    for info in images:
        got = image_io.read_image(os.path.join(folder, "synth_coco", "val2017",
                                               info["file_name"]))
        if got.shape != (info["height"], info["width"], 3):
            raise AssertionError(f"decode {info['file_name']}: {got.shape}, annotated "
                                 f"{info['height']}x{info['width']}")
    phase(7, f"decoded the split's {len(images)} JPEGs at their annotated sizes")
    return found


def run_eval_cli(torch, kernels):
    """Phase 7 (b): ``relation_detr_tpu_torch.test`` on the flagship config
    (seeded weights) at B=2 over the split, twice (the first meets every
    canvas anew): launches of the path's two kernels, finite detections,
    stats equal to the --eval-json re-score of its own results JSON;
    canvases, the 12 stats, images/s and ms per image by stage."""
    import tempfile

    import numpy as np

    from relation_detr_tpu_torch import test as eval_cli
    from relation_detr_tpu_torch.data import image_io
    from relation_detr_tpu_torch.ops import msda, relation_bias

    coco = os.path.join(ROOT, EVAL_DATA, "synth_coco")
    runs = []
    with tempfile.TemporaryDirectory() as tmp:
        out = os.path.join(tmp, "results.json")
        args = ["--coco-path", coco, "--batch-size", str(EVAL_BATCH), "--device", "cuda"]
        for run in range(2):
            msda.multi_scale_deformable_attention.launches = 0
            relation_bias.relation_bias_v4.launches = 0
            image_io.ycc_to_rgb.launches = 0
            torch.cuda.reset_peak_memory_stats()
            got = eval_cli.main(args + ["--result-json", out])
            torch.cuda.synchronize()
            launches = (msda.multi_scale_deformable_attention.launches,
                        relation_bias.relation_bias_v4.launches, image_io.ycc_to_rgb.launches)
            batches = -(-got["images"] // EVAL_BATCH)
            unchecked = set(map(tuple, got["canvases"])) - set(kernels["msda"]["eval_canvases"])
            if unchecked:
                raise AssertionError(f"eval CLI batched canvases {sorted(unchecked)} that phase 3 "
                                     "did not hold msda_fwd on")
            if launches != (12 * batches, 5 * batches, got["images"]):
                raise AssertionError(f"eval CLI: {launches} msda_fwd / relation_bias_v4_fwd / "
                                     f"ycc_to_rgb launches over {batches} batches, expected "
                                     "12 / 5 a batch and one ycc_to_rgb an image")
            with open(out) as f:
                predictions = json.load(f)
            if len(predictions) != 300 * got["images"] or not all(
                    np.isfinite(p["bbox"]).all() and np.isfinite(p["score"])
                    for p in predictions):
                raise AssertionError("eval CLI: expected 300 finite detections per image")
            rescored = eval_cli.main(["--coco-path", coco, "--eval-json", out])["stats"]
            if rescored != got["stats"]:
                raise AssertionError(f"eval CLI stats {got['stats']} differ from the "
                                     f"--eval-json re-score {rescored}")
            peak = torch.cuda.max_memory_allocated()
            ms = got["ms_per_image"]
            phase(7, f"eval CLI run {run} (flagship, seeded weights, B={EVAL_BATCH}): "
                     f"{got['images']} images in {got['seconds']:.3f} s, "
                     f"{got['images_per_s']:.3f} images/s; canvases {got['canvases']}; "
                     f"{launches[0]} msda_fwd + {launches[1]} relation_bias_v4_fwd + "
                     f"{launches[2]} ycc_to_rgb launches; "
                     "ms per image: " + ", ".join(f"{k} {v:.3f}" for k, v in ms.items()) +
                     f"; peak memory {peak / 2**30:.3f} GiB; stats equal the --eval-json "
                     "re-score: " + ", ".join(f"{k} {got['stats'][k]:.4f}" for k in STATS))
            runs.append(dict(images=got["images"], canvases=got["canvases"],
                             seconds=got["seconds"], images_per_s=got["images_per_s"],
                             ms_per_image=ms, launches=launches, peak_gib=peak / 2**30,
                             stats=got["stats"]))
    kernels["msda"]["eval_cli_launches"] = runs[-1]["launches"][0]
    kernels["relation"]["eval_cli_launches"] = runs[-1]["launches"][1]
    kernels["ycc_to_rgb"]["launches"] = runs[-1]["launches"][2]
    return runs


def cycled_split(folder, cycles):
    """The committed split ``cycles`` times over in ``folder``: an
    annotations file whose images and annotations repeat with new ids (the
    same file names), and ``val2017`` a link to the committed images."""
    coco = os.path.join(ROOT, EVAL_DATA, "synth_coco")
    with open(os.path.join(coco, "annotations", "instances_val2017.json")) as f:
        split = json.load(f)
    step = 1 + max(max(i["id"] for i in split["images"]),
                   max(a["id"] for a in split["annotations"]))
    split["images"] = [dict(i, id=i["id"] + step * r)
                       for r in range(cycles) for i in split["images"]]
    split["annotations"] = [dict(a, id=a["id"] + step * r, image_id=a["image_id"] + step * r)
                            for r in range(cycles) for a in split["annotations"]]
    os.makedirs(os.path.join(folder, "annotations"))
    with open(os.path.join(folder, "annotations", "instances_val2017.json"), "w") as f:
        json.dump(split, f)
    os.symlink(os.path.join(coco, "val2017"), os.path.join(folder, "val2017"))
    return folder


def run_eval_throughput(torch, kernels):
    """Phase 7 (c): the eval CLI over EVAL_CYCLES repeats of the split (new
    image ids, so the evaluator scores every image): images/s and ms per
    image by stage over hundreds of images, launches 12 / 5 a batch."""
    import tempfile

    from relation_detr_tpu_torch import test as eval_cli
    from relation_detr_tpu_torch.ops import msda, relation_bias

    with tempfile.TemporaryDirectory() as tmp:
        coco = cycled_split(tmp, EVAL_CYCLES)
        msda.multi_scale_deformable_attention.launches = 0
        relation_bias.relation_bias_v4.launches = 0
        got = eval_cli.main(["--coco-path", coco, "--batch-size", str(EVAL_BATCH),
                             "--device", "cuda"])
    launches = (msda.multi_scale_deformable_attention.launches,
                relation_bias.relation_bias_v4.launches)
    batches = -(-got["images"] // EVAL_BATCH)
    if got["images"] != 8 * EVAL_CYCLES or launches != (12 * batches, 5 * batches):
        raise AssertionError(f"eval CLI over the cycled split: {got['images']} images, "
                             f"{launches} msda_fwd / relation_bias_v4_fwd launches over "
                             f"{batches} batches")
    ms = got["ms_per_image"]
    phase(7, f"eval CLI over the split {EVAL_CYCLES} times (flagship, seeded weights, "
             f"B={EVAL_BATCH}): {got['images']} images in {got['seconds']:.3f} s, "
             f"{got['images_per_s']:.3f} images/s; canvases {got['canvases']}; ms per image "
             "(decode, transform: host time summed over the loader's threads; pin, "
             "evaluator: host; copy, forward: spans on the card's stream): " +
             ", ".join(f"{k} {v:.3f}" for k, v in ms.items()))
    return dict(images=got["images"], seconds=got["seconds"],
                images_per_s=got["images_per_s"], ms_per_image=ms, launches=launches)


def ground_truth_det_fn(torch, loader, ann_file, seed):
    """A detections function that answers each image of ``loader``'s
    batches (in its order) with its ground-truth boxes, xyxy in the
    original image's pixels, every coordinate moved by a seeded offset in
    [-2, 2] px, scores 0.9 down by 0.01, labels the category ids; then one
    row of score 0 (a 1x1 box at the origin) an image."""
    from collections import defaultdict

    import numpy as np

    with open(ann_file) as f:
        coco = json.load(f)
    boxes = defaultdict(list)
    for a in coco["annotations"]:
        x, y, w, h = a["bbox"]
        boxes[a["image_id"]].append([x, y, x + w, y + h, a["category_id"]])
    rng = np.random.RandomState(seed)
    batches = iter(loader._batches())
    first = coco["categories"][0]["id"]

    def det_fn(images, mask, orig_sizes):
        ids = [loader.dataset.ids[i] for i in next(batches)]
        rows = np.zeros((images.shape[0], 1 + max(len(boxes[i]) for i in ids), 6), np.float32)
        rows[..., 2:4], rows[..., 5] = 1.0, first
        for b, image_id in enumerate(ids):
            for k, (*xyxy, cat) in enumerate(boxes[image_id]):
                rows[b, k] = [*(np.asarray(xyxy) + rng.uniform(-2, 2, 4)), 0.9 - 0.01 * k, cat]
        return torch.from_numpy(rows).to(images.device)

    return det_fn


def check_ground_truth_control(torch):
    """Phase 7 (d): a control with nonzero AP. The split's jittered ground
    truth as the detections (``ground_truth_det_fn``) through the CLI's
    ``evaluate`` (nvJPEG decode, the flagship eval preset, B=2,
    ``detection_stream``, ``accumulate_batch``, ``--result-json``): AP50 1,
    AP above 0.5, the stats equal to the --eval-json re-score."""
    import tempfile

    from relation_detr_tpu_torch import test as eval_cli
    from relation_detr_tpu_torch.data.coco import CocoDetection
    from relation_detr_tpu_torch.data.loader import DataLoader
    from relation_detr_tpu_torch.data.transforms import EvalPreset

    coco = os.path.join(ROOT, EVAL_DATA, "synth_coco")
    ann = os.path.join(coco, "annotations", "instances_val2017.json")
    dataset = CocoDetection(os.path.join(coco, "val2017"), ann,
                            EvalPreset(800, 1333, normalize_host=False), device="cuda")
    loader = DataLoader(dataset, batch_size=EVAL_BATCH, shuffle=False)
    with tempfile.TemporaryDirectory() as tmp:
        out = os.path.join(tmp, "results.json")
        got = eval_cli.evaluate(ground_truth_det_fn(torch, loader, ann, seed=3), loader, ann,
                                "cuda", result_json=out)
        rescored = eval_cli.main(["--coco-path", coco, "--eval-json", out])["stats"]
    stats = got["stats"]
    if not (stats["AP50"] == 1.0 and 0.5 < stats["AP"] < 1.0) or rescored != stats:
        raise AssertionError(f"ground-truth control: stats {stats}, --eval-json re-score "
                             f"{rescored}; expected AP50 1, AP in (0.5, 1) and equal stats")
    phase(7, f"ground-truth control over the split's {got['images']} images (jittered boxes "
             "through the CLI's evaluate, --result-json and --eval-json): stats equal the "
             "re-score: " + ", ".join(f"{k} {stats[k]:.4f}" for k in STATS))
    return stats


def check_tiny_eval(torch):
    """Phase 7 (e): the tiny-test config over the split's batches (decoded
    on the card, its own eval preset) through ``make_detections_fn`` on the
    card (kernels) and on the CPU (plain versions), same weights: the
    normalised canvases bit-identical and the pre-top-k heads at
    TOL_MODEL."""
    from relation_detr_tpu_torch.data.coco import CocoDetection
    from relation_detr_tpu_torch.data.loader import DataLoader
    from relation_detr_tpu_torch.data.transforms import EvalPreset
    from relation_detr_tpu_torch.utils.evaluation import make_detections_fn, upload

    cfg = importlib.import_module(CONFIGS + "relation_detr_resnet50_tiny_test")
    cpu_model = cfg.build_model(device="cpu", seed=1)
    gpu_model = copy.deepcopy(cpu_model).to("cuda")
    seen = {}
    hooks = []
    for key, model in (("cpu", cpu_model), ("cuda", gpu_model)):
        hooks.append(model.register_forward_pre_hook(
            lambda m, args, key=key: seen.__setitem__(key, {"images": args[0].cpu()})))
        hooks.append(model.register_forward_hook(
            lambda m, args, out, key=key: seen[key].update(
                {k: out[k].cpu() for k in ("pred_logits", "pred_boxes")})))
    coco = os.path.join(ROOT, EVAL_DATA, "synth_coco")
    dataset = CocoDetection(os.path.join(coco, "val2017"),
                            os.path.join(coco, "annotations", "instances_val2017.json"),
                            EvalPreset(cfg.min_size, cfg.max_size, normalize_host=False),
                            device="cuda")
    fns = {key: make_detections_fn(m, cfg.select_box_nums_for_evaluation)
           for key, m in (("cpu", cpu_model), ("cuda", gpu_model))}
    errs = {"images": 0.0, "pred_logits": 0.0, "pred_boxes": 0.0}
    try:
        for batch in DataLoader(dataset, batch_size=EVAL_BATCH):
            for key, fn in fns.items():
                fn(*upload(batch, torch.device(key)))
            for name in errs:
                got, want = seen["cuda"][name], seen["cpu"][name]
                if name != "images":
                    torch.testing.assert_close(got, want, rtol=TOL_MODEL, atol=TOL_MODEL)
                errs[name] = max(errs[name], (got - want).abs().max().item())
    finally:
        for h in hooks:
            h.remove()
    if errs["images"] != 0:
        raise AssertionError(f"the card's normalisation differs from the CPU's by "
                             f"{errs['images']}")
    phase(7, f"tiny-test config over the split's {len(dataset)} images, B={EVAL_BATCH}, GPU "
             f"(kernels) vs CPU (plain): normalised canvases max abs diff "
             f"{errs['images']:.3e}, pred_logits {errs['pred_logits']:.3e}, pred_boxes "
             f"{errs['pred_boxes']:.3e} (tolerance {TOL_MODEL})")
    return errs


def run_evaluation(torch, kernels):
    """Phase 7: the COCO evaluation path (decode, CLI, tiny parity)."""
    decode = check_decode()
    runs = run_eval_cli(torch, kernels)
    throughput = run_eval_throughput(torch, kernels)
    control = check_ground_truth_control(torch)
    tiny = check_tiny_eval(torch)
    return dict(decode=decode, cli_runs=runs, throughput=throughput,
                ground_truth_control=control, tiny_max_abs=tiny)


# phase 8, the train CLI: the committed synthetic train split (16 JPEGs of
# tests/make_synth_coco.py) through relation_detr_tpu_torch.train on the
# flagship config: B=2 on the 800x1344 canvas, 2 micro-steps an update, an
# EMA, 2 epochs (16 steps, 8 updates), an evaluation each epoch over the val
# split; then a resume for a third epoch
TRAIN_BATCH = 2
TRAIN_IMAGES = 16
TRAIN_EPOCHS = 2
TRAIN_ACCUMULATE = 2
TRAIN_EMA = 0.9998
TRAIN_SKIP = 2  # steps of run (a) left out of its numbers (model and loader warm-up)
def train_cli_args(out, epochs, *extra):
    coco = os.path.join(ROOT, EVAL_DATA, "synth_coco")
    return ["--coco-path", coco, "--output-dir", out, "--num-epochs", str(epochs),
            "--batch-size", str(TRAIN_BATCH), "--canvas", f"{CANVAS[0]},{CANVAS[1]}",
            "--accumulate-steps", str(TRAIN_ACCUMULATE), "--ema-decay", str(TRAIN_EMA),
            "--eval-every-epochs", "1", "--seed", "0", "--device", "cuda", *extra]


def train_cli_counters():
    from relation_detr_tpu_torch.data import image_io
    from relation_detr_tpu_torch.ops import msda, relation_bias

    return {"msda_fwd": msda.multi_scale_deformable_attention, "msda_bwd": msda.msda_backward,
            "relation_bias_v4_fwd": relation_bias.relation_bias_v4,
            "ycc_to_rgb": image_io.ycc_to_rgb}


def run_train_cli_checked(torch, args, epochs, label, bf16=False, per_step=18):
    """One train CLI run with every counter set to 0 just before it: the
    launches must be ``per_step`` msda_fwd (18 with the hybrid pass, 12
    without; twice that with ``bf16``, whose runs recompute the layers under
    "dots"), ``per_step`` msda_bwd and 5 relation_bias_v4_fwd a step, 12
    msda_fwd and 5 relation_bias_v4_fwd an evaluated image (B=1), and one
    ycc_to_rgb an image read, and with ``bf16`` every MSDA launch of
    the bf16-value forms; every step's loss finite, no skipped step.
    Returns (the CLI's result, launches, peak GiB, load averages)."""
    from relation_detr_tpu_torch import train

    counters = train_cli_counters()
    if bf16:
        counters["msda_fwd_bf16"] = Bf16Launches(counters["msda_fwd"])
        counters["msda_bwd_bf16"] = Bf16Launches(counters["msda_bwd"])
    for fn in counters.values():
        fn.launches = 0
    load = os.getloadavg()
    torch.cuda.reset_peak_memory_stats()
    got = train.main(args)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() / 2**30
    load = (load, os.getloadavg())
    launches = {k: fn.launches for k, fn in counters.items()}
    steps, evals = len(got["steps"]), 8 * len(got["evals"])
    fwd = (2 if bf16 else 1) * per_step * steps + 12 * evals
    want = {"msda_fwd": fwd, "msda_bwd": per_step * steps,
            "relation_bias_v4_fwd": 5 * steps + 5 * evals,
            "ycc_to_rgb": TRAIN_IMAGES * epochs + evals}
    if bf16:
        want.update(msda_fwd_bf16=fwd, msda_bwd_bf16=per_step * steps)
    if launches != want:
        raise AssertionError(f"{label}: launches {launches} over {steps} steps and {evals} "
                             f"evaluated images, expected {want}")
    losses = [s["total_loss"] for s in got["steps"]]
    if not all(math.isfinite(v) for v in losses) or got["metrics"]["nonfinite_count"] or \
            not all(math.isfinite(v) for k, v in got["metrics"].items() if k.startswith("loss")):
        raise AssertionError(f"{label}: non-finite losses {losses}, metrics {got['metrics']}")
    return got, launches, peak, load


def train_cli_numbers(got, peak, load):
    """Phase 8 (d): run (a)'s numbers past its first TRAIN_SKIP steps."""
    steps = got["steps"][TRAIN_SKIP:]
    times = [s["step"] for s in steps]
    waits = [s["wait"] for s in steps]
    periods = [b["start"] - a["start"] for a, b in zip(steps, steps[1:])
               if a["epoch"] == b["epoch"]]  # not across an epoch's end (evaluation)
    return dict(steps=len(steps), step_ms_p50=statistics.median(times),
                step_ms_range=[min(times), max(times)],
                images_per_s=TRAIN_BATCH * len(periods) / sum(periods),
                wait_ms_p50=statistics.median(waits), wait_ms_max=max(waits),
                pin_ms_p50=statistics.median(s["pin"] for s in steps),
                upload_ms_per_step=got["upload_ms"] / len(got["steps"]),
                peak_gib=peak, loadavg_before=list(load[0]), loadavg_after=list(load[1]))


def check_train_outputs(torch, out, got):
    """Phase 8 (a): each update's lr is the schedule's at its count; the
    checkpoints hold epochs 0 and 1 beside latest.npz, latest_ema.npz and
    best_ap.npz; latest.npz loads into a fresh model with nothing missing or
    mismatched and equals the last checkpoint's model; the EMA is neither
    the initial nor the latest weights. Returns counts for the record."""
    from relation_detr_tpu_torch.configs import train_config
    from relation_detr_tpu_torch.utils.checkpoint import CheckpointManager
    from relation_detr_tpu_torch.utils.param_groups import warmup_multistep_schedule
    from relation_detr_tpu_torch.utils.weights import load_weights

    steps_per_epoch = TRAIN_IMAGES // TRAIN_BATCH
    schedule = warmup_multistep_schedule(train_config.learning_rate, steps_per_epoch,
                                         milestones_epochs=train_config.lr_milestones,
                                         gamma=train_config.lr_gamma)
    want = [schedule(i) for i in range(len(got["lrs"]))]
    if len(got["lrs"]) != TRAIN_EPOCHS * steps_per_epoch // TRAIN_ACCUMULATE or got["lrs"] != want:
        raise AssertionError(f"update lrs {got['lrs']}, expected the schedule's {want}")
    manager = CheckpointManager(os.path.join(out, "checkpoints"))
    files = [f for f in ("latest.npz", "latest_ema.npz", "best_ap.npz")
             if os.path.isfile(os.path.join(out, f))]
    if manager.epochs() != [0, 1] or len(files) != 3:
        raise AssertionError(f"checkpoints {manager.epochs()}, weight files {files}")
    saved = manager.restore(map_location="cpu")
    cfg = importlib.import_module(CONFIGS + "relation_detr_resnet50_800_1333")
    fresh = cfg.build_model(device="cpu", seed=0)  # the run's initial weights
    initial = {n: p.detach().clone() for n, p in fresh.named_parameters()}
    report = load_weights(fresh, os.path.join(out, "latest.npz"))
    if report["missing"] or report["mismatched"]:
        raise AssertionError(f"latest.npz: {len(report['missing'])} missing, "
                             f"{len(report['mismatched'])} mismatched")
    for k, v in fresh.state_dict().items():
        if not torch.equal(v, saved["model"][k]):
            raise AssertionError(f"latest.npz's {k} differs from the checkpoint's")
    trainable = [n for n, p in fresh.named_parameters() if p.requires_grad]
    moved = [n for n in trainable if not torch.equal(saved["model"][n], initial[n])]
    ema_vs_latest = sum(not torch.equal(saved["ema"][n], saved["model"][n]) for n in moved)
    ema_vs_initial = sum(not torch.equal(saved["ema"][n], initial[n]) for n in moved)
    if ema_vs_latest != len(moved) or ema_vs_initial < len(moved) // 2:
        raise AssertionError(f"EMA: {ema_vs_latest} of {len(moved)} moved tensors differ from "
                             f"the latest weights, {ema_vs_initial} from the initial ones")
    return dict(tensors=len(report["loaded"]), trainable=len(trainable), moved=len(moved),
                ema_differs_from_latest=ema_vs_latest, ema_differs_from_initial=ema_vs_initial)


def check_restore(torch, out, precision="no"):
    """Phase 8 (b): the train CLI's ``restore_training`` into a fresh model
    (other weights), AdamW, train step and EMA: every tensor and count
    bit-identical to the last checkpoint's. ``precision``: the run's
    ``--mixed-precision``."""
    from relation_detr_tpu_torch.configs import train_config
    from relation_detr_tpu_torch.parallel.train_step import make_train_step
    from relation_detr_tpu_torch.train import restore_training
    from relation_detr_tpu_torch.utils.checkpoint import CheckpointManager
    from relation_detr_tpu_torch.utils.ema import ema_init
    from relation_detr_tpu_torch.utils.param_groups import build_optimizer

    cfg = importlib.import_module(CONFIGS + "relation_detr_resnet50_800_1333")
    dtype = "bfloat16" if precision == "bf16" else None
    model = cfg.build_model(device="cuda", seed=11, backbone_dtype=dtype,
                            compute_dtype=dtype).train()
    optimizer = build_optimizer(model, train_config.learning_rate,
                                accumulate_steps=TRAIN_ACCUMULATE)
    step = make_train_step(model, cfg.build_criterion(), optimizer, cfg.hybrid_assign)
    ema = ema_init(dict(model.named_parameters()))
    manager = CheckpointManager(os.path.join(out, "checkpoints"))
    restore_training(manager, model, optimizer, step, ema, "cuda", precision)
    saved = torch.load(manager.path(manager.latest_epoch()), map_location="cuda",
                       weights_only=True)
    checked = 0
    for k, v in model.state_dict().items():
        checked += torch.equal(v, saved["model"][k]) or _differs(f"model {k}")
    opt = optimizer.state_dict()
    for i, s in saved["optimizer"]["state"].items():
        for k, v in s.items():
            checked += torch.equal(opt["state"][i][k], v) or _differs(f"AdamW {i} {k}")
    mine = step.state_dict()
    if mine["state"] != saved["train_step"]["state"]:
        _differs(f"train step state {mine['state']} vs {saved['train_step']['state']}")
    for k, v in saved["train_step"]["accumulator"].items():
        checked += torch.equal(mine["accumulator"][k], v) or _differs(f"accumulator {k}")
    for k, v in saved["ema"].items():
        checked += torch.equal(ema[k], v) or _differs(f"EMA {k}")
    state = saved["train_step"]["state"]
    del model, optimizer, step, ema, saved
    torch.cuda.empty_cache()
    return dict(tensors=checked, **state)


def _differs(what):
    raise AssertionError(f"restored {what} differs from the checkpoint")


def check_overfit_on_card(torch):
    """Phase 8 (c): the tiny config learns on the card: the case of
    ``relation_detr_tpu_torch/utils/overfit.py`` (tests/test_overfit_learns.py's
    4 images, steps, lr and thresholds), as tests/test_torch_overfit_learns.py
    runs it on the CPU."""
    import tempfile

    from relation_detr_tpu_torch.utils import overfit

    with tempfile.TemporaryDirectory() as tmp:
        result = overfit.run("cuda", os.path.join(tmp, "overfit.json"))
    first, last, stats = result["first_loss"], result["last_loss"], result["stats"]
    if not result["ok"]:
        raise AssertionError(f"tiny overfit on the card: loss {first:.4f} -> {last:.4f} "
                             f"(at most {overfit.LOSS_RATIO}x), AP50 {stats['AP50']:.4f} "
                             f"(at least {overfit.MIN_AP50})")
    phase(8, f"tiny config overfit on the card ({overfit.STEPS} steps, {overfit.B} images "
             f"{overfit.H}x{overfit.W}): loss {first:.4f} -> {last:.4f} ({last / first:.4f}x, "
             f"at most {overfit.LOSS_RATIO}), AP {stats['AP']:.4f}, AP50 {stats['AP50']:.4f} "
             f"(at least {overfit.MIN_AP50})")
    return dict(first_loss=first, last_loss=last, AP=stats["AP"], AP50=stats["AP50"])


def run_train(torch, kernels):
    """Phase 8: the train CLI. (a) the flagship config at full width over the
    committed train split, 2 epochs with accumulation, an EMA and an
    evaluation each epoch; (b) a resume of it for a third epoch; (c) the
    tiny config's overfit on the card; (d) run (a)'s numbers."""
    import tempfile

    smi = _run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"])
    with tempfile.TemporaryDirectory() as tmp:
        first, resumed = os.path.join(tmp, "a"), os.path.join(tmp, "b")
        got, launches, peak, load = run_train_cli_checked(
            torch, train_cli_args(first, TRAIN_EPOCHS), TRAIN_EPOCHS, "train CLI (a)")
        for key, row in (("msda_fwd", "msda"), ("msda_bwd", "msda_bwd"),
                         ("relation_bias_v4_fwd", "relation"), ("ycc_to_rgb", "ycc_to_rgb")):
            kernels[row]["train_cli_launches"] = launches[key]
        outputs = check_train_outputs(torch, first, got)
        numbers = train_cli_numbers(got, peak, load)
        phase(8, f"train CLI (a): flagship B={TRAIN_BATCH} {CANVAS[0]}x{CANVAS[1]} fp32, "
                 f"{len(got['steps'])} steps ({TRAIN_ACCUMULATE} a update, {len(got['lrs'])} "
                 f"updates at the schedule's lrs), EMA {TRAIN_EMA}, {TRAIN_EPOCHS} epochs over "
                 f"{TRAIN_IMAGES} JPEGs (nvJPEG, detr preset) and an evaluation each "
                 f"(AP50 {[round(e['stats']['AP50'], 4) for e in got['evals']]}); launches "
                 f"{launches}; losses finite, none skipped; checkpoints of epochs 0 and 1, "
                 f"latest.npz ({outputs['tensors']} tensors, none missing or mismatched, equal to "
                 f"the checkpoint), latest_ema.npz, best_ap.npz; the EMA differs from the "
                 f"latest weights in {outputs['ema_differs_from_latest']} and from the initial "
                 f"ones in {outputs['ema_differs_from_initial']} of the {outputs['moved']} "
                 f"trained tensors that moved")
        phase(8, f"train CLI (d) [{smi}], steps {TRAIN_SKIP}-{len(got['steps']) - 1}: step "
                 f"p50 {numbers['step_ms_p50']:.3f} ms (range {numbers['step_ms_range'][0]:.3f}"
                 f"-{numbers['step_ms_range'][1]:.3f}); {numbers['images_per_s']:.3f} images/s "
                 f"(within epochs); main thread's wait for the next batch p50 "
                 f"{numbers['wait_ms_p50']:.3f} ms (max {numbers['wait_ms_max']:.3f}); pinning "
                 f"p50 {numbers['pin_ms_p50']:.3f} ms; upload span (side stream, copies and "
                 f"normalisation) {numbers['upload_ms_per_step']:.3f} ms a step; peak memory "
                 f"{numbers['peak_gib']:.3f} GiB; load average {numbers['loadavg_before']} "
                 f"before, {numbers['loadavg_after']} after")
        restored = check_restore(torch, first)
        again, launches_b, _, _ = run_train_cli_checked(
            torch, train_cli_args(resumed, TRAIN_EPOCHS + 1, "--resume", first), 1,
            "train CLI (b)")
        from relation_detr_tpu_torch.configs import train_config
        from relation_detr_tpu_torch.utils.checkpoint import CheckpointManager
        from relation_detr_tpu_torch.utils.param_groups import warmup_multistep_schedule

        schedule = warmup_multistep_schedule(train_config.learning_rate,
                                             TRAIN_IMAGES // TRAIN_BATCH)
        updates = restored["updates"]
        want_lrs = [schedule(updates + i) for i in range(len(again["lrs"]))]
        epochs = {s["epoch"] for s in again["steps"]}
        saved = CheckpointManager(os.path.join(resumed, "checkpoints")).epochs()
        if epochs != {TRAIN_EPOCHS} or len(again["steps"]) != TRAIN_IMAGES // TRAIN_BATCH or \
                again["lrs"] != want_lrs or saved != [TRAIN_EPOCHS] or \
                [e["epoch"] for e in again["evals"]] != [TRAIN_EPOCHS]:
            raise AssertionError(f"resume: epochs {epochs}, {len(again['steps'])} steps, lrs "
                                 f"{again['lrs']} (want {want_lrs}), checkpoints {saved}")
        phase(8, f"train CLI (b): restore_training into a fresh model, AdamW, train step and "
                 f"EMA: {restored['tensors']} tensors and the counts (step {restored['step']}, "
                 f"updates {updates}, micro-steps {restored['micro_steps']}) bit-identical to "
                 f"the checkpoint; --resume trained epoch {TRAIN_EPOCHS} only "
                 f"({len(again['steps'])} steps, updates {updates}-"
                 f"{updates + len(again['lrs']) - 1} at the schedule's lrs, launches "
                 f"{launches_b}), evaluated it and saved its checkpoint")
        bf16 = run_train_cli_bf16(torch, tmp)
    overfit = check_overfit_on_card(torch)
    return dict(device=smi, numbers=numbers, outputs=outputs, restored=restored,
                launches=launches, evals=[e["stats"]["AP50"] for e in got["evals"]],
                overfit=overfit, bf16=bf16)


BF16_CLI_FLAGS = ("--mixed-precision", "bf16", "--remat-policy", "dots")


def run_train_cli_bf16(torch, tmp):
    """Phase 8 (e): the train CLI with --mixed-precision bf16 --remat-policy
    dots, one epoch as run (a) takes it (an evaluation included), the
    restore into a fresh bf16 model bit-identical to its checkpoint, and a
    --resume for a second epoch; its step p50 and numbers beside run (a)'s."""
    first, resumed = os.path.join(tmp, "e"), os.path.join(tmp, "f")
    got, launches, peak, load = run_train_cli_checked(
        torch, train_cli_args(first, 1, *BF16_CLI_FLAGS), 1, "train CLI (e)", bf16=True)
    numbers = train_cli_numbers(got, peak, load)
    restored = check_restore(torch, first, "bf16")
    again, launches_b, _, _ = run_train_cli_checked(
        torch, train_cli_args(resumed, 2, "--resume", first, *BF16_CLI_FLAGS), 1,
        "train CLI (e) resume", bf16=True)
    if {s["epoch"] for s in again["steps"]} != {1} or \
            len(again["steps"]) != TRAIN_IMAGES // TRAIN_BATCH:
        raise AssertionError(f"bf16 resume: {len(again['steps'])} steps")
    phase(8, f"train CLI (e): {' '.join(BF16_CLI_FLAGS)}, flagship B={TRAIN_BATCH}, 1 epoch "
             f"({len(got['steps'])} steps) and an evaluation; launches {launches}; step p50 "
             f"{numbers['step_ms_p50']:.3f} ms (range {numbers['step_ms_range'][0]:.3f}-"
             f"{numbers['step_ms_range'][1]:.3f}, steps {TRAIN_SKIP}-{len(got['steps']) - 1}), "
             f"{numbers['images_per_s']:.3f} images/s, peak memory {numbers['peak_gib']:.3f} "
             f"GiB; restore_training into a fresh bf16 model: {restored['tensors']} tensors "
             f"bit-identical; --resume trained epoch 1 only ({len(again['steps'])} steps, "
             f"launches {launches_b})")
    return dict(numbers=numbers, launches=launches, restored=restored["tensors"])


PORT_KERNELS = ("msda_", "relation_bias", "to_bf16_kernel", "tiled_core", "sep_contract",
                "window_acc", "ycc_to_rgb")


def kernel_bucket(op, types, name):
    """The bucket of one device kernel of a precision profile, from the
    innermost operator that launched it (its name and input dtypes, as
    torch.profiler records them with record_shapes) and its own name."""
    if any(k in name for k in PORT_KERNELS):
        return "port kernels"
    if op is None:
        return "memcpy / memset" if name.startswith(("Memcpy", "Memset")) else "unattributed"
    dtype = next((t for t in types if t in ("float", "c10::BFloat16")), None)
    prec = {"float": "fp32", "c10::BFloat16": "bf16"}.get(dtype, "other dtype")
    if op in ("aten::mm", "aten::addmm", "aten::bmm", "aten::baddbmm", "aten::addbmm"):
        return f"{prec} GEMMs"
    if "convolution" in op:
        return f"{prec} convolutions"
    if op == "aten::copy_" and len(types) > 1 and types[0] != types[1]:
        return "casts"
    return f"other {prec}"


def profile_precision(torch, label, fn):
    """Phase 9: one run of fn under torch.profiler (record_shapes), each
    device kernel put in a ``kernel_bucket`` through the chrome trace's
    operator input types: device ms per bucket, their share of the busy
    time, busy against the host-clock span (synchronised at both ends), the
    idle share, and the 5 largest kernels of the fp32 GEMMs and the casts."""
    import tempfile

    from torch.profiler import ProfilerActivity, profile

    fn()  # warm-up: no first-call costs in the window
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 record_shapes=True) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        span = (time.perf_counter() - t0) * 1e3
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    ops = {ev["args"]["External id"]: (ev["name"], ev["args"].get("Input type", []))
           for ev in events if ev.get("cat") == "cpu_op" and "External id" in ev.get("args", {})}
    buckets, top = {}, {}
    for ev in events:
        if ev.get("cat") not in ("kernel", "gpu_memcpy", "gpu_memset"):
            continue
        op, types = ops.get(ev.get("args", {}).get("External id"), (None, []))
        bucket = kernel_bucket(op, types, ev["name"])
        ms = ev.get("dur", 0) / 1e3
        buckets[bucket] = buckets.get(bucket, 0.0) + ms
        top.setdefault(bucket, {}).setdefault(ev["name"][:90], 0.0)
        top[bucket][ev["name"][:90]] += ms
    busy = sum(buckets.values())
    if busy == 0:
        phase(10, f"{label}: torch.profiler saw no device time (not measured)")
        return None
    shares = {k: [v, v / busy] for k, v in sorted(buckets.items(), key=lambda kv: -kv[1])}
    phase(10, f"{label}: span {span:.3f} ms (host clock, synchronised), device busy "
             f"{busy:.3f} ms, idle share {1 - busy / span:.4f}; by bucket (ms, share of busy): "
             + "; ".join(f"{k} {v[0]:.3f} ({v[1]:.3f})" for k, v in shares.items()))
    for bucket in ("fp32 GEMMs", "fp32 convolutions", "casts", "unattributed", "other fp32"):
        if bucket in top:
            largest = sorted(top[bucket].items(), key=lambda kv: -kv[1])[:5]
            phase(10, f"{label}: largest {bucket}: " +
                  "; ".join(f"{n} {ms:.3f} ms" for n, ms in largest))
    return dict(span_ms=span, busy_ms=busy, idle_share=1 - busy / span, buckets=shares)


def check_precision_profiles(torch, model32, model16, step16):
    """Phase 9: the precision profile of one flagship detect in fp32 and in
    bf16 (B=1, 800x1344), and of one bf16 train step (B=1, GT capacity 100,
    remat unset)."""
    from relation_detr_tpu_torch.inference import detect

    gen = torch.Generator(device="cuda").manual_seed(21)
    images = torch.randn(1, *CANVAS, 3, generator=gen, device="cuda")
    mask = torch.zeros(1, *CANVAS, dtype=torch.bool, device="cuda")
    out = {}
    for name, model in (("fp32", model32), ("bf16", model16)):
        model.eval()
        out[f"detect_{name}"] = profile_precision(
            torch, f"flagship B=1 detect, {name}",
            lambda model=model: detect(model, images, mask, [list(CANVAS)], 100))
    model, step, batch = step16
    model.train()
    out["step_bf16"] = profile_precision(torch, "flagship B=1 train step, bf16, remat unset",
                                         lambda: step(batch))
    return out


def check_train_cli_busy(torch):
    """Phase 9: one train CLI step (the 4th of a run; flagship, B=2) traced
    with the CLI's --profile-steps: device-busy time against its span."""
    import tempfile

    from relation_detr_tpu_torch import train

    with tempfile.TemporaryDirectory() as tmp:
        got = train.main(train_cli_args(tmp, 1, "--max-steps", "4", "--profile-steps", "3,4",
                                        "--eval-every-epochs", "0"))
    prof = got["profile"]
    if prof is None or not prof["device_busy_ms"]:
        phase(10, "train CLI step: torch.profiler saw no device time (not measured)")
        return None
    prof = {k: v for k, v in prof.items() if k != "trace"}
    phase(10, f"train CLI step (flagship B={TRAIN_BATCH}, --profile-steps 3,4): span "
             f"{prof['span_ms']:.3f} ms (host clock, synchronised), device busy "
             f"{prof['device_busy_ms']:.3f} ms (torch.profiler), idle share "
             f"{prof['idle_share']:.4f}")
    return prof


# phase 9, the model families: the port's copies of the JAX package's
# configs/{dino_pp,deformable_detr_pp,dn_def_detr_pp,dab_def_detr_pp}, each
# with the relation bias's N in its eval and its train forwards (DINO++: 900
# queries, + 200 CDN slots; DN-Def-DETR++: 300, + 5 groups x 60 DN slots)
FAMILY_CONFIGS = {
    "dino_pp": ("dino_pp.dino_pp_resnet50_800_1333", 900, 1100),
    "def_detr_pp": ("deformable_detr_pp.def_detr_pp_resnet50_800_1333", 300, 300),
    "dn_def_detr_pp": ("dn_def_detr_pp.dn_def_detr_pp_resnet50_800_1333", 300, 600),
    "dab_def_detr_pp": ("dab_def_detr_pp.dab_def_detr_pp_resnet50_800_1333", 300, 300),
}
FAMILY_BASE = "relation_detr_tpu_torch.configs."
SA_DET = "relation_detr.relation_detr_resnet50_sa_det_100k"
FAMILY_TRAIN_RUN = (1, 100, 1, 3)  # B, GT capacity, warm-up, timed
# tests/test_model_families.py's tiny size and each family's switches
TINY_FAMILY = dict(num_classes=10, num_queries=30, hybrid_num_proposals=40, denoising_nums=4,
                   transformer_enc_layers=1, transformer_dec_layers=2, backbone_arch="resnet18")
TINY_FAMILIES = {
    "dino_pp": dict(with_hybrid=False, denoising="cdn", encoder_memory_fusion=False,
                    query_source="tgt_embed"),
    "def_detr_pp": dict(with_hybrid=False, denoising=None, encoder_memory_fusion=False,
                        query_source="tgt_embed"),
    "dn_def_detr_pp": dict(with_hybrid=False, denoising="dn", dn_groups=3,
                           encoder_memory_fusion=False, query_source="learned_anchor"),
    "dab_def_detr_pp": dict(with_hybrid=False, denoising=None, encoder_memory_fusion=False,
                            query_source="memory"),
}


def tiny_family(torch, family):
    """The family's tiny model on the CPU (seeded weights) and its criterion."""
    from relation_detr_tpu_torch.losses.criterion import CriterionConfig
    from relation_detr_tpu_torch.models.detector import RelationDETR

    model = RelationDETR(**TINY_FAMILY, **TINY_FAMILIES[family],
                         generator=torch.Generator().manual_seed(1))
    return model.eval(), CriterionConfig(num_classes=TINY_FAMILY["num_classes"],
                                         class_loss_type="focal",
                                         two_stage_binary_cls=family == "def_detr_pp")


def family_kernels():
    from relation_detr_tpu_torch.ops import msda, relation_bias

    return {"msda_fwd": msda.multi_scale_deformable_attention, "msda_bwd": msda.msda_backward,
            "relation_bias_v4_fwd": relation_bias.relation_bias_v4}


def record_family_launches(kernels, path, launches, field="family_launches"):
    """Each kernel row's ``field[path]``: the launches of one of phase 9's
    (phase 11's: ``large_backbone_launches``) paths, its counters set to 0
    just before it."""
    for key, row in (("msda_fwd", "msda"), ("msda_bwd", "msda_bwd"),
                     ("relation_bias_v4_fwd", "relation")):
        kernels[row].setdefault(field, {})[path] = launches[key]


def check_tiny_family_eval(torch, family):
    """Phase 9 (c): the family's tiny model on the GPU (kernels) and the CPU
    (plain versions), same weights and inputs: every decoder layer's heads
    and, when two-stage, the encoder top-k's heads and the class logits and
    boxes the top-k selected, at TOL_MODEL. Returns the max abs diffs."""
    cpu_model, _ = tiny_family(torch, family)
    gpu_model = copy.deepcopy(cpu_model).to("cuda")
    gen = torch.Generator().manual_seed(2)
    images = torch.randn(2, 256, 320, 3, generator=gen)
    mask = torch.zeros(2, 256, 320, dtype=torch.bool)
    mask[1, 192:] = True
    mask[1, :, 240:] = True
    images[mask] = 0.0
    with torch.inference_mode(), TopkRecorder() as cpu_topk:
        want = cpu_model(images, mask)
    with torch.inference_mode(), TopkRecorder() as gpu_topk:
        got = gpu_model(images.cuda(), mask.cuda())
    if ("enc_outputs" in got) != (family != "dn_def_detr_pp") or set(got) != set(want):
        raise AssertionError(f"tiny {family}: outputs {sorted(got)}, CPU {sorted(want)}")
    pairs = [(k, got[k], want[k]) for k in ("pred_logits", "pred_boxes")]
    pairs += [(f"{s}/{k}", got[s][k], want[s][k]) for s in ("aux_outputs", "enc_outputs")
              if s in got for k in ("pred_logits", "pred_boxes")]
    pairs += [(f"top-k {what}", g, c) for gsel, csel in zip(gpu_topk.indices, cpu_topk.indices)
              for what, g, c in zip(("class logits", "boxes"), gsel[:2], csel[:2])]
    errs = {}
    for label, g, w in pairs:
        torch.testing.assert_close(g.cpu(), w, rtol=TOL_MODEL, atol=TOL_MODEL, msg=lambda m:
                                   f"tiny {family} GPU vs CPU {label}: {m}")
        errs[label] = (g.cpu() - w).abs().max().item()
    phase(9, f"[{family}] tiny model GPU (kernels) vs CPU (plain) eval: " +
          ", ".join(f"{k} {v:.3e}" for k, v in errs.items()) + f" (tolerance {TOL_MODEL})")
    return errs


def family_request(torch, gen, h, w):
    images = torch.zeros(1, *CANVAS, 3, device="cuda")
    images[0, :h, :w] = torch.randn(h, w, 3, generator=gen, device="cuda")
    mask = torch.ones(1, *CANVAS, dtype=torch.bool, device="cuda")
    mask[0, :h, :w] = False
    return images, mask, [[h, w]]


def family_optimizer(model):
    from relation_detr_tpu_torch.configs import train_config
    from relation_detr_tpu_torch.utils.param_groups import build_optimizer

    return build_optimizer(model, train_config.learning_rate,
                           weight_decay=train_config.weight_decay, betas=train_config.betas,
                           max_norm=train_config.max_norm)


def run_family(torch, family, kernels):
    """Phase 9 (a): the family config at full width. 4 requests through
    ``inference.detect`` after one warm-up (12 msda_fwd and 5
    relation_bias_v4_fwd launches each, the relation bias at the family's
    eval N), then FAMILY_TRAIN_RUN's train steps (12 msda_fwd, 12 msda_bwd
    and 5 relation_bias_v4_fwd a step, the bias at its train N; the loss
    terms the family has, all finite)."""
    from relation_detr_tpu_torch.inference import detect
    from relation_detr_tpu_torch.parallel.train_step import make_train_step

    module, n_eval, n_train = FAMILY_CONFIGS[family]
    cfg = importlib.import_module(FAMILY_BASE + module)
    # what earlier phases keep on the card (the flagship models phase 10
    # profiles): the peaks below are reported above it
    resident = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    model = cfg.build_model(device="cuda", seed=0)
    build_s = time.perf_counter() - t0
    widths, raw = [], {}  # the relation bias's (N1, N2) per call; the raw heads
    hooks = [model.transformer.decoder.position_relation_embedding.register_forward_hook(
                 lambda mod, args, out: widths.append(tuple(out.shape[-2:]))),
             model.register_forward_hook(lambda mod, args, out: raw.update(out))]
    counters = family_kernels()
    gen = torch.Generator(device="cuda").manual_seed(11)
    topk = cfg.select_box_nums_for_evaluation
    detect(model, *family_request(torch, gen, *REQUESTS[0]), topk)  # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for fn in counters.values():
        fn.launches = 0
    widths.clear()
    times = []
    q = cfg.num_queries
    for i, (h, w) in enumerate(REQUESTS):
        before = {k: fn.launches for k, fn in counters.items()}
        images, mask, sizes = family_request(torch, gen, h, w)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        det = detect(model, images, mask, sizes, topk)
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
        got = {k: fn.launches - before[k] for k, fn in counters.items()}
        if got != {"msda_fwd": 12, "msda_bwd": 0, "relation_bias_v4_fwd": 5}:
            raise AssertionError(f"{family} request {i}: launches {got}, expected 12 msda_fwd "
                                 "and 5 relation_bias_v4_fwd")
        if raw["pred_logits"].shape != (1, q, 91) or det["boxes"].shape != (1, topk, 4) or \
                ("enc_outputs" in raw) != (family != "dn_def_detr_pp"):
            raise AssertionError(f"{family} request {i}: logits {raw['pred_logits'].shape}, "
                                 f"detections {det['boxes'].shape}, outputs {sorted(raw)}")
        for t in (raw["pred_logits"], raw["pred_boxes"], det["scores"], det["boxes"]):
            if not bool(torch.isfinite(t).all()):
                raise AssertionError(f"{family} request {i}: non-finite outputs")
    eval_launches = {k: fn.launches for k, fn in counters.items()}
    if set(widths) != {(n_eval, n_eval)} or len(widths) != 5 * len(REQUESTS):
        raise AssertionError(f"{family}: relation bias widths {sorted(set(widths))} over "
                             f"{len(widths)} calls, expected N={n_eval}")
    eval_peak = (torch.cuda.max_memory_allocated() - resident) / 2**30
    phase(9, f"[{family}] built in {build_s:.1f} s ({sum(p.numel() for p in model.parameters())} "
             f"parameters, {q} queries); B=1 {CANVAS[0]}x{CANVAS[1]} detect over "
             f"{len(REQUESTS)} requests: p50 {statistics.median(times):.3f} ms (range "
             f"{min(times):.3f}-{max(times):.3f}), peak memory {eval_peak:.3f} GiB above the "
             f"{resident / 2**30:.3f} GiB earlier phases hold; {topk} "
             f"finite detections each; launches {eval_launches} (relation bias N={n_eval})")
    record_family_launches(kernels, f"{family} eval", eval_launches)

    model.train()
    step = make_train_step(model, cfg.build_criterion(), family_optimizer(model), seed=0)
    bs, cap, warmup, timed = FAMILY_TRAIN_RUN
    batch = synthetic_batch(torch, gen, bs, cap, CANVAS, "cuda", REQUESTS[0])
    per_step = {"msda_fwd": 12, "msda_bwd": 12, "relation_bias_v4_fwd": 5}
    for fn in counters.values():
        fn.launches = 0
    widths.clear()
    last = {}
    train_times, train_peak = train_steps(
        torch, step, batch, warmup, timed,
        {k: (counters[k], e) for k, e in per_step.items()}, f"B={bs} GT capacity {cap}",
        title=family, n=9, last=last)
    train_launches = {k: fn.launches for k, fn in counters.items()}
    for hook in hooks:
        hook.remove()
    if set(widths) != {(n_train, n_train)}:
        raise AssertionError(f"{family} train: relation bias widths {sorted(set(widths))}, "
                             f"expected N={n_train}")
    denoised = cfg.model_args.get("denoising") is not None
    terms = {k for k in last if k.startswith("loss")}
    if any(k.endswith("_dn") for k in terms) != denoised or \
            any(k.endswith("_enc") for k in terms) != (family != "dn_def_detr_pp") or \
            any(k.endswith("_hybrid") for k in terms):
        raise AssertionError(f"{family} train: loss terms {sorted(terms)}")
    train_peak = (train_peak - resident) / 2**30
    phase(9, f"[{family}] train launches {train_launches} over {warmup + timed} steps "
             f"(relation bias N={n_train}); {len(terms)} loss terms, grad_norm "
             f"{last['grad_norm']:.4f}; peak memory {train_peak:.3f} GiB above the resident")
    record_family_launches(kernels, f"{family} train", train_launches)
    return dict(queries=q, relation_n=[n_eval, n_train], detect_ms_p50=statistics.median(times),
                detect_ms=times, detect_peak_gib=eval_peak,
                step_ms_p50=statistics.median(train_times), step_ms=train_times,
                step_peak_gib=train_peak, resident_gib=resident / 2**30, loss_terms=len(terms),
                grad_norm=last["grad_norm"], eval_launches=eval_launches,
                train_launches=train_launches)


def run_sa_det(torch, kernels):
    """Phase 9 (b): the SA-Det config (Relation-DETR, 2 classes) at full
    width: one detect (12 msda_fwd, 5 relation_bias_v4_fwd) and one train
    step with every label 1 (18 msda_fwd, 18 msda_bwd, 5
    relation_bias_v4_fwd: the hybrid pass), all finite."""
    from relation_detr_tpu_torch.inference import detect
    from relation_detr_tpu_torch.parallel.train_step import make_train_step

    cfg = importlib.import_module(FAMILY_BASE + SA_DET)
    resident = torch.cuda.memory_allocated()
    model = cfg.build_model(device="cuda", seed=0)
    counters = family_kernels()
    gen = torch.Generator(device="cuda").manual_seed(12)
    for fn in counters.values():
        fn.launches = 0
    raw = {}
    hook = model.register_forward_hook(lambda mod, args, out: raw.update(out))
    det = detect(model, *family_request(torch, gen, *REQUESTS[0]),
                 cfg.select_box_nums_for_evaluation)
    torch.cuda.synchronize()
    hook.remove()
    eval_launches = {k: fn.launches for k, fn in counters.items()}
    if eval_launches != {"msda_fwd": 12, "msda_bwd": 0, "relation_bias_v4_fwd": 5} or \
            raw["pred_logits"].shape != (1, 900, 2) or \
            not all(bool(torch.isfinite(t).all()) for t in (raw["pred_logits"], det["boxes"])):
        raise AssertionError(f"SA-Det detect: launches {eval_launches}, logits "
                             f"{raw['pred_logits'].shape}")
    record_family_launches(kernels, "sa_det eval", eval_launches)
    model.train()
    step = make_train_step(model, cfg.build_criterion(), family_optimizer(model),
                           cfg.hybrid_assign, seed=0)
    batch = synthetic_batch(torch, gen, 1, 100, CANVAS, "cuda", REQUESTS[0])
    batch["gt_labels"][batch["gt_valid"]] = 1
    for fn in counters.values():
        fn.launches = 0
    last = {}
    times, peak = train_steps(
        torch, step, batch, 0, 1,
        {k: (counters[k], e) for k, e in (("msda_fwd", 18), ("msda_bwd", 18),
                                          ("relation_bias_v4_fwd", 5))},
        "B=1 GT capacity 100, labels 1", title="SA-Det", n=9, last=last)
    train_launches = {k: fn.launches for k, fn in counters.items()}
    record_family_launches(kernels, "sa_det train", train_launches)
    phase(9, f"[SA-Det] detect: logits {tuple(raw['pred_logits'].shape)}, "
             f"{cfg.select_box_nums_for_evaluation} finite detections, launches "
             f"{eval_launches}; train step launches {train_launches}, "
             f"{sum(k.startswith('loss') for k in last)} loss terms finite")
    return dict(step_ms=times[0], step_peak_gib=(peak - resident) / 2**30,
                eval_launches=eval_launches,
                train_launches=train_launches)


def run_family_clis(torch, kernels):
    """Phase 9 (d): the train CLI on the DINO++ config, one epoch over the
    committed train split at B=2 with its evaluation (12 msda_fwd, 12
    msda_bwd and 5 relation_bias_v4_fwd a step: no hybrid pass), and the
    eval CLI on the DN-Def-DETR++ config over the val split at B=2 (12
    msda_fwd and 5 relation_bias_v4_fwd a batch, 300 finite detections an
    image); every metric finite."""
    import tempfile

    import numpy as np

    from relation_detr_tpu_torch import test as eval_cli
    from relation_detr_tpu_torch.data import image_io

    configs = os.path.join(ROOT, "relation_detr_tpu_torch", "configs")
    dino = os.path.join(configs, "dino_pp", "dino_pp_resnet50_800_1333.py")
    dn = os.path.join(configs, "dn_def_detr_pp", "dn_def_detr_pp_resnet50_800_1333.py")
    coco = os.path.join(ROOT, EVAL_DATA, "synth_coco")
    with tempfile.TemporaryDirectory() as tmp:
        got, launches, peak, _ = run_train_cli_checked(
            torch, train_cli_args(os.path.join(tmp, "dino"), 1, "--model-config", dino), 1,
            "train CLI [dino_pp]", per_step=12)
        stats = [e["stats"] for e in got["evals"]]
        if len(stats) != 1 or not all(math.isfinite(v) for v in stats[0].values()):
            raise AssertionError(f"train CLI [dino_pp]: evaluations {stats}")
        step_ms = [s["step"] for s in got["steps"][TRAIN_SKIP:]]
        record_family_launches(kernels, "dino_pp train CLI", launches)
        phase(9, f"train CLI [dino_pp] B={TRAIN_BATCH}, 1 epoch ({len(got['steps'])} steps) "
                 f"and its evaluation: launches {launches}; step p50 "
                 f"{statistics.median(step_ms):.3f} ms past the first {TRAIN_SKIP}; peak "
                 f"memory {peak:.3f} GiB; losses finite; AP50 {stats[0]['AP50']:.4f}")
        counters = family_kernels()
        counters["ycc_to_rgb"] = image_io.ycc_to_rgb
        for fn in counters.values():
            fn.launches = 0
        out = os.path.join(tmp, "results.json")
        evaluated = eval_cli.main(["--coco-path", coco, "--batch-size", str(EVAL_BATCH),
                                   "--device", "cuda", "--model-config", dn,
                                   "--result-json", out])
        torch.cuda.synchronize()
        eval_launches = {k: fn.launches for k, fn in counters.items()}
        batches = -(-evaluated["images"] // EVAL_BATCH)
        want = {"msda_fwd": 12 * batches, "msda_bwd": 0, "relation_bias_v4_fwd": 5 * batches,
                "ycc_to_rgb": evaluated["images"]}
        if eval_launches != want:
            raise AssertionError(f"eval CLI [dn_def_detr_pp]: launches {eval_launches}, "
                                 f"expected {want}")
        with open(out) as f:
            predictions = json.load(f)
        if len(predictions) != 300 * evaluated["images"] or not all(
                np.isfinite(p["bbox"]).all() and np.isfinite(p["score"]) for p in predictions):
            raise AssertionError("eval CLI [dn_def_detr_pp]: expected 300 finite detections "
                                 "per image")
        if not all(math.isfinite(v) for v in evaluated["stats"].values()):
            raise AssertionError(f"eval CLI [dn_def_detr_pp]: stats {evaluated['stats']}")
    record_family_launches(kernels, "dn_def_detr_pp eval CLI", eval_launches)
    phase(9, f"eval CLI [dn_def_detr_pp] B={EVAL_BATCH}: {evaluated['images']} images, "
             f"{evaluated['images_per_s']:.3f} images/s, launches {eval_launches}, 300 finite "
             f"detections an image, stats finite (AP {evaluated['stats']['AP']:.4f})")
    return dict(train_cli=dict(steps=len(got["steps"]), step_ms_p50=statistics.median(step_ms),
                               peak_gib=peak, launches=launches, stats=stats[0]),
                eval_cli=dict(images=evaluated["images"],
                              images_per_s=evaluated["images_per_s"],
                              launches=eval_launches, stats=evaluated["stats"]))


def run_families(torch, kernels):
    """Phase 9: (a) each family at full width, (b) SA-Det, (c) each
    family's tiny model GPU vs CPU, eval and train, (d) the two CLIs."""
    smi = _run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"])
    results = {"card": smi}
    for family in FAMILY_CONFIGS:
        results[family] = run_family(torch, family, kernels)
        torch.cuda.empty_cache()
    results["sa_det"] = run_sa_det(torch, kernels)
    torch.cuda.empty_cache()
    for family in FAMILY_CONFIGS:
        results[family]["tiny_eval_max_abs"] = check_tiny_family_eval(torch, family)
        check_tiny_train(torch, "gather", {}, None, family=family, n=9)
    results.update(run_family_clis(torch, kernels))
    phase(9, f"[{smi}] " + "; ".join(
        f"{f}: detect p50 {results[f]['detect_ms_p50']:.3f} ms, {results[f]['detect_peak_gib']:.3f}"
        f" GiB, step p50 {results[f]['step_ms_p50']:.3f} ms, {results[f]['step_peak_gib']:.3f} GiB"
        for f in FAMILY_CONFIGS))
    return results


# phase 11, the models with large backbones: the port's copies of the JAX
# package's four large configs at full width (seeded weights), and a tiny
# form of each backbone family on the tiny-test config
LARGE_CONFIGS = {  # label: (config module, canvas)
    "swin_l": ("relation_detr_swin_l_800_1333", CANVAS),
    "convnext_l": ("relation_detr_convnext_l_800_1333", CANVAS),
    "focalnet_l": ("relation_detr_focalnet_large_lrf_fl4_800_1333", CANVAS),
    "focalnet_l_1200": ("relation_detr_focalnet_large_lrf_fl4_1200_2000", LARGE_CANVAS),
}
# original (h, w) of the 1200x2000 config's requests: EvalPreset(1200, 2000)
# resizes them to 1200x2000, 1200x1800, 1000x2000 and 1200x1600
LARGE_REQUESTS = ((600, 1000), (480, 720), (500, 1000), (900, 1200))
LARGE_TRAIN_RUN = (1, 100, 1, 3)  # B, GT capacity, warm-up, timed
STAGE_RUNS = 3  # detects timed by stage (hooks), after the p50's
TINY_BACKBONES = {  # arch: (port module, ARCH_SETTINGS entry)
    "swin_smoke": ("swin", (16, (2, 2, 2, 2), (2, 2, 4, 8), 7, False)),
    "swin_v2_smoke": ("swin", (16, (2, 2, 2, 2), (2, 2, 4, 8), 8, True)),
    "convnext_smoke": ("convnext", ((8, 16, 32, 64), (1, 1, 2, 1))),
    "focalnet_smoke": ("focalnet", (16, (1, 1, 1, 1), (4,) * 4, (3,) * 4, True, True, True,
                                    True)),
}


def register_tiny_backbones(table=TINY_BACKBONES):
    for arch, (module, entry) in table.items():
        importlib.import_module(
            f"relation_detr_tpu_torch.models.backbones.{module}").ARCH_SETTINGS[arch] = entry


def check_tiny_backbone_eval(torch, arch, n=11, dcn=None):
    """Phase ``n`` (a): the tiny-test config on ``arch`` (``dcn``: its
    ResNet's stage flags, the DCNs perturbed by ``perturb_dcn``), GPU
    (kernels) against CPU (plain versions), same weights and inputs: the
    encoder's class and box heads over every token before the two-stage
    top-k, and the decoder's heads, at TOL_MODEL. Returns the max abs
    diffs."""
    from relation_detr_tpu_torch.configs import build_detector

    cfg = importlib.import_module(CONFIGS + "relation_detr_resnet50_tiny_test")
    cpu_model = build_detector(dict(cfg.model_args, backbone_arch=arch,
                                    backbone_stage_with_dcn=dcn), "cpu", 1)
    gen = torch.Generator().manual_seed(2)
    if dcn is not None:
        perturb_dcn(torch, cpu_model, gen)
    gpu_model = copy.deepcopy(cpu_model).to("cuda")
    images = torch.randn(2, 256, 320, 3, generator=gen)
    mask = torch.zeros(2, 256, 320, dtype=torch.bool)
    mask[1, 192:] = True
    mask[1, :, 240:] = True
    images[mask] = 0.0
    names = ("encoder_class_head", "encoder_bbox_head")
    outs = {}
    for label, model, dev in (("gpu", gpu_model, "cuda"), ("cpu", cpu_model, "cpu")):
        pre = {}
        hooks = [getattr(model.transformer, n).register_forward_hook(
            lambda mod, a, out, n=n, pre=pre: pre.__setitem__(n, out.cpu())) for n in names]
        with torch.inference_mode():
            out = model(images.to(dev), mask.to(dev))
        for hook in hooks:
            hook.remove()
        outs[label] = {**pre, **{k: out[k].cpu() for k in ("pred_logits", "pred_boxes")}}
    errs = {}
    for key, want in outs["cpu"].items():
        got = outs["gpu"][key]
        torch.testing.assert_close(got, want, rtol=TOL_MODEL, atol=TOL_MODEL, msg=lambda m:
                                   f"tiny {arch} GPU vs CPU {key}: {m}")
        errs[key] = (got - want).abs().max().item()
    arch = arch if dcn is None else f"{arch} with DCN {dcn}"
    phase(n, f"[{arch}] tiny-test config GPU (kernels) vs CPU (plain) eval, before the top-k "
              "and after: " + ", ".join(f"{k} {v:.3e}" for k, v in errs.items()) +
          f" (tolerance {TOL_MODEL})")
    return errs


def large_requests(torch, gen, canvas):
    """((images, mask, orig sizes), valid (h, w)) of each request on
    ``canvas``: REQUESTS' valid sizes on the 800x1344 canvas; on
    LARGE_CANVAS, LARGE_REQUESTS' random images through EvalPreset(1200,
    2000) (host resize and normalisation, as the eval CLI's preset does)."""
    import numpy as np

    from relation_detr_tpu_torch.data.transforms import EvalPreset

    if canvas == CANVAS:
        return [(family_request(torch, gen, h, w), (h, w)) for h, w in REQUESTS]
    out = []
    preset = EvalPreset(1200, 2000)
    rng = np.random.RandomState(14)
    for h, w in LARGE_REQUESTS:
        sample = preset({"image": rng.randint(0, 256, (h, w, 3)).astype(np.uint8),
                         "boxes": np.zeros((0, 4), np.float32)})
        image = torch.from_numpy(np.ascontiguousarray(sample["image"])).cuda()
        vh, vw = image.shape[:2]
        images = torch.zeros(1, *canvas, 3, device="cuda")
        images[0, :vh, :vw] = image
        mask = torch.ones(1, *canvas, dtype=torch.bool, device="cuda")
        mask[0, :vh, :vw] = False
        out.append(((images, mask, [[h, w]]), (vh, vw)))
    return out


class StageTimer:
    """CUDA events around the backbone, the neck, the encoder, the decoder
    and the whole transformer of ``model`` (forward hooks). ``split()``
    gives the ms of each stage in the last forward; "two-stage" is the
    transformer's time outside its encoder and decoder (input flattening,
    the encoder output heads, the top-k and the query set-up)."""

    STAGES = ("backbone", "neck", "encoder", "decoder", "transformer")

    def __init__(self, torch, model):
        self.torch, self.events, self.hooks = torch, {}, []
        mods = dict(backbone=model.backbone, neck=model.neck,
                    encoder=model.transformer.encoder, decoder=model.transformer.decoder,
                    transformer=model.transformer)
        for name, mod in mods.items():
            self.hooks.append(mod.register_forward_pre_hook(
                lambda *_, name=name: self._record(name, 0)))
            self.hooks.append(mod.register_forward_hook(
                lambda *_, name=name: self._record(name, 1)))

    def _record(self, name, end):
        event = self.torch.cuda.Event(enable_timing=True)
        event.record()
        self.events.setdefault(name, [None, None])[end] = event

    def split(self):
        self.torch.cuda.synchronize()
        ms = {k: v[0].elapsed_time(v[1]) for k, v in self.events.items()}
        ms["two-stage"] = ms.pop("transformer") - ms["encoder"] - ms["decoder"]
        return ms

    def remove(self):
        for hook in self.hooks:
            hook.remove()


def large_model_spec(label, overrides):
    """(config module, canvas, model_args) of a phase-11 config
    (``overrides`` None) or of the flagship config with ``overrides`` on its
    model_args (phase 12)."""
    if overrides is None:
        module, canvas = LARGE_CONFIGS[label]
        cfg = importlib.import_module(CONFIGS + module)
        return cfg, canvas, cfg.model_args
    cfg = importlib.import_module(CONFIGS + FLAGSHIP)
    return cfg, CANVAS, dict(cfg.model_args, **overrides)


def run_large_model(torch, label, kernels, overrides=None, n=11):
    """Phase ``n`` (b): a large config (phase 12: the flagship config with
    ``overrides``) at full width, fp32, seeded weights. 4
    requests through ``inference.detect`` after one warm-up (12 msda_fwd and
    5 relation_bias_v4_fwd launches each, and with a DCN backbone one
    bilinear_sample_fwd a DCN; 300 finite detections), the p50 and
    range of their CUDA-event times and the peak memory above what earlier
    phases keep resident; STAGE_RUNS detects timed by stage (``StageTimer``);
    then LARGE_TRAIN_RUN's train steps (18 msda_fwd, 18 msda_bwd and 5
    relation_bias_v4_fwd a step, and one bilinear_sample_fwd and one
    bilinear_sample_bwd a DCN; every loss term and the gradient norm
    finite; a DCN's offset convs must get a non-zero gradient). Returns the
    numbers, the model and the first request."""
    from relation_detr_tpu_torch.configs import build_detector
    from relation_detr_tpu_torch.inference import detect
    from relation_detr_tpu_torch.parallel.train_step import make_train_step

    from relation_detr_tpu_torch.models.deform_conv import DeformConv2dPack
    from relation_detr_tpu_torch.ops import grid_sample

    cfg, canvas, model_args = large_model_spec(label, overrides)
    field = "large_backbone_launches" if overrides is None else "vit_dcn_launches"
    resident = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    model = build_detector(model_args, "cuda", 0)
    build_s = time.perf_counter() - t0
    raw = {}
    hook = model.register_forward_hook(lambda mod, args, out: raw.update(out))
    counters = family_kernels()
    # a DCN backbone's samplers: one bilinear_sample_fwd launch a DCN a
    # forward, one bilinear_sample_bwd a DCN a backward
    dcns = sum(isinstance(m, DeformConv2dPack) for m in model.modules())
    if dcns:
        counters.update(bilinear_sample_fwd=grid_sample.bilinear_sample,
                        bilinear_sample_bwd=grid_sample.bilinear_sample_backward)
    per_detect = {"msda_fwd": 12, "msda_bwd": 0, "relation_bias_v4_fwd": 5}
    if dcns:
        per_detect.update(bilinear_sample_fwd=dcns, bilinear_sample_bwd=0)
    gen = torch.Generator(device="cuda").manual_seed(15)
    topk = cfg.select_box_nums_for_evaluation
    requests, sizes = zip(*large_requests(torch, gen, canvas))
    detect(model, *requests[0], topk)  # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for fn in counters.values():
        fn.launches = 0
    times = []
    for i, request in enumerate(requests):
        before = {k: fn.launches for k, fn in counters.items()}
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        det = detect(model, *request, topk)
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
        got = {k: fn.launches - before[k] for k, fn in counters.items()}
        if got != per_detect:
            raise AssertionError(f"{label} request {i}: launches {got}, expected {per_detect}")
        if raw["pred_logits"].shape != (1, 900, 91) or det["boxes"].shape != (1, topk, 4):
            raise AssertionError(f"{label} request {i}: logits {raw['pred_logits'].shape}, "
                                 f"detections {det['boxes'].shape}")
        for t in (raw["pred_logits"], raw["pred_boxes"], det["scores"], det["boxes"]):
            if not bool(torch.isfinite(t).all()):
                raise AssertionError(f"{label} request {i}: non-finite outputs")
    eval_launches = {k: fn.launches for k, fn in counters.items()}
    eval_peak = (torch.cuda.max_memory_allocated() - resident) / 2**30
    timer = StageTimer(torch, model)
    splits = []
    for _ in range(STAGE_RUNS):
        detect(model, *requests[0], topk)
        splits.append(timer.split())
    timer.remove()
    hook.remove()
    stages = {k: statistics.median(s[k] for s in splits) for k in splits[0]}
    phase(n, f"[{label}] built in {build_s:.1f} s ({sum(p.numel() for p in model.parameters())} "
              f"parameters); B=1 {canvas[0]}x{canvas[1]} detect over {len(requests)} requests "
              f"(valid {list(sizes)}): p50 {statistics.median(times):.3f} ms (range "
              f"{min(times):.3f}-{max(times):.3f}), peak memory {eval_peak:.3f} GiB above the "
              f"{resident / 2**30:.3f} GiB earlier phases hold; {topk} finite detections each; "
              f"launches {eval_launches}; by stage (median of {STAGE_RUNS}, CUDA events): " +
          ", ".join(f"{k} {v:.3f} ms" for k, v in stages.items()))
    record_family_launches(kernels, f"{label} eval", eval_launches, field)

    model.train()
    offset_grads = {}  # a DCN offset conv's largest |grad| in each step
    grad_hooks = [param.register_hook(
        lambda g, name=name: offset_grads.setdefault(name, []).append(g.abs().max()))
        for name, param in model.named_parameters() if ".conv_offset." in name]
    step = make_train_step(model, cfg.build_criterion(), family_optimizer(model),
                           cfg.hybrid_assign, seed=0)
    bs, cap, warmup, timed = LARGE_TRAIN_RUN
    batch = synthetic_batch(torch, gen, bs, cap, canvas, "cuda", sizes[0])
    per_step = {"msda_fwd": 18, "msda_bwd": 18, "relation_bias_v4_fwd": 5}
    if dcns:
        per_step.update(bilinear_sample_fwd=dcns, bilinear_sample_bwd=dcns)
    for fn in counters.values():
        fn.launches = 0
    last = {}
    train_times, train_peak = train_steps(
        torch, step, batch, warmup, timed,
        {k: (counters[k], e) for k, e in per_step.items()}, f"B={bs} GT capacity {cap}",
        title=label, n=n, last=last, canvas=canvas)
    train_launches = {k: fn.launches for k, fn in counters.items()}
    record_family_launches(kernels, f"{label} train", train_launches, field)
    train_peak = (train_peak - resident) / 2**30
    for hook in grad_hooks:
        hook.remove()
    offset_grad = None
    if grad_hooks:
        if len(offset_grads) != len(grad_hooks):
            raise AssertionError(f"{label}: {len(grad_hooks) - len(offset_grads)} DCN offset "
                                 "convs got no gradient")
        offset_grad = min(max(g.item() for g in grads) for grads in offset_grads.values())
        if not offset_grad > 0 or not math.isfinite(offset_grad):
            raise AssertionError(f"{label}: a DCN offset conv's gradient is {offset_grad}")
    phase(n, f"[{label}] train launches {train_launches} over {warmup + timed} steps; "
             f"{sum(k.startswith('loss') for k in last)} loss terms and the gradient norm "
             f"{last['grad_norm']:.4f} finite; peak memory {train_peak:.3f} GiB above the "
             "resident" + ("" if offset_grad is None else
                           f"; each of the {len(grad_hooks) // 2} DCN offset convs' weight "
                           f"and bias got a non-zero gradient (smallest max |grad| "
                           f"{offset_grad:.3e})"))
    del step
    model.eval()
    return dict(canvas=list(canvas), valid_sizes=list(sizes), build_s=build_s,
                parameters=sum(p.numel() for p in model.parameters()),
                detect_ms_p50=statistics.median(times), detect_ms=times,
                detect_peak_gib=eval_peak, stage_ms=stages,
                step_ms_p50=statistics.median(train_times), step_ms=train_times,
                step_peak_gib=train_peak, resident_gib=resident / 2**30,
                grad_norm=last["grad_norm"], eval_launches=eval_launches,
                train_launches=train_launches, dcn_offset_grad_min=offset_grad, dcns=dcns),\
        model, requests[0]


def check_bf16_backbone(torch, label, model32, request, overrides=None, n=11):
    """Phase ``n`` (b): ``label``'s model under the bf16 policy
    (backbone_dtype = compute_dtype = bf16, ``model32``'s weights), one
    detect; the transformer runs its bf16 forms (12 msda_fwd_bf16). A
    backbone the JAX package keeps fp32 (Swin, EVA-02: it gives the
    backbone dtype to the ResNet only) must return fp32 outputs equal to
    the fp32 model's on the same request bit for bit. A DCN ResNet's plain
    convs must compute in bf16 while every DCN is fed and computes in fp32
    (the JAX module has no dtype; the FrozenBN before it promotes)."""
    from relation_detr_tpu_torch.configs import build_detector
    from relation_detr_tpu_torch.inference import detect
    from relation_detr_tpu_torch.models.deform_conv import DeformConv2dPack
    from relation_detr_tpu_torch.ops import msda

    _, _, model_args = large_model_spec(label, overrides)
    model16 = build_detector(model_args, "cuda", 0, backbone_dtype="bfloat16",
                             compute_dtype="bfloat16")
    model16.load_state_dict(model32.state_dict())  # the weights after its train steps
    dcns = [m for m in model16.backbone.modules() if isinstance(m, DeformConv2dPack)]
    feats, dtypes = {}, []
    hooks = [m.backbone.register_forward_hook(
        lambda mod, args, out, k=k: feats.__setitem__(k, [o.clone() for o in out]))
        for k, m in (("fp32", model32), ("bf16", model16))]
    hooks += [m.register_forward_hook(lambda mod, args, out: dtypes.append(
        ("dcn", args[0].dtype, out.dtype))) for m in dcns]
    if dcns:
        hooks.append(model16.backbone.layer2[0].conv1.register_forward_hook(
            lambda mod, args, out: dtypes.append(("conv1", args[0].dtype, out.dtype))))
    detect(model32, *request, 300)
    before = msda.multi_scale_deformable_attention.bf16_launches
    det = detect(model16, *request, 300)
    torch.cuda.synchronize()
    launches = msda.multi_scale_deformable_attention.bf16_launches - before
    for hook in hooks:
        hook.remove()
    del model16
    if launches != 12 or not bool(torch.isfinite(det["scores"]).all()):
        raise AssertionError(f"{label} bf16 detect: {launches} msda_fwd_bf16 launches")
    shapes = [tuple(f.shape) for f in feats["bf16"]]
    if dcns:
        fp32 = (torch.float32, torch.float32)
        if [d[1:] for d in dtypes if d[0] == "dcn"] != [fp32] * len(dcns) or \
                [d[1:] for d in dtypes if d[0] == "conv1"] != [(torch.bfloat16,) * 2]:
            raise AssertionError(f"{label} bf16 policy: (input, output) dtypes {dtypes}")
        phase(n, f"[{label}] bf16 policy detect: {launches} msda_fwd_bf16 launches; each of the "
                 f"{len(dcns)} DCNs fed and computing in fp32, layer2.0.conv1 in bf16; backbone "
                 f"outputs {[str(f.dtype) for f in feats['bf16']]} {shapes}")
        return dict(msda_fwd_bf16=launches, dcn_fp32=len(dcns))
    for i, (got, want) in enumerate(zip(feats["bf16"], feats["fp32"])):
        if got.dtype != torch.float32 or not torch.equal(got, want):
            raise AssertionError(f"{label} bf16 policy: backbone output {i} is {got.dtype}, "
                                 "not the fp32 run's bit for bit")
    phase(n, f"[{label}] bf16 policy detect: {launches} msda_fwd_bf16 launches, the "
             f"{len(shapes)} backbone outputs fp32 and bit-identical to the fp32 run's {shapes}")
    return dict(msda_fwd_bf16=launches, backbone_fp32_bit_identical=True)


def run_large_backbones(torch, kernels):
    """Phase 11: (a) each backbone family's tiny form on the tiny-test
    config, GPU against CPU, eval and one train step; (b) the four large
    configs at full width (``run_large_model``), the Swin-L one also under
    the bf16 policy."""
    register_tiny_backbones()
    smi = _run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"])
    results = {"card": smi, "tiny": {}}
    for arch in TINY_BACKBONES:
        results["tiny"][arch] = check_tiny_backbone_eval(torch, arch)
        check_tiny_train(torch, "gather", {}, None, n=11, backbone=arch)
    for label in LARGE_CONFIGS:
        results[label], model, request = run_large_model(torch, label, kernels)
        if label == "swin_l":
            results[label]["bf16"] = check_bf16_backbone(torch, label, model, request)
        del model, request
        torch.cuda.empty_cache()
    phase(11, f"[{smi}] " + "; ".join(
        f"{k}: detect p50 {results[k]['detect_ms_p50']:.3f} ms, "
        f"{results[k]['detect_peak_gib']:.3f} GiB, step p50 {results[k]['step_ms_p50']:.3f} ms, "
        f"{results[k]['step_peak_gib']:.3f} GiB" for k in LARGE_CONFIGS))
    return results


# phase 12, ViT, EVA-02 and the DCN ResNet. No config of the JAX package
# uses them, so each is the flagship config with its backbone fields
# overridden, as the JAX RelationDETR takes them
FLAGSHIP = "relation_detr_resnet50_800_1333"
DCN_STAGES = (False, True, True, True)
VIT_DCN_MODELS = {  # label: the flagship config's model_args overridden
    "vit_b": dict(backbone_arch="vit_b"),
    "vit_l": dict(backbone_arch="vit_l"),
    "eva_02_vit_b": dict(backbone_arch="eva_02_vit_b_4attn_1024"),
    "eva_02_vit_l": dict(backbone_arch="eva_02_vit_l_4attn_1024"),
    "r50_dcn": dict(backbone_stage_with_dcn=DCN_STAGES),
}
VIT_DCN_BF16 = ("eva_02_vit_l", "r50_dcn")  # one bf16 detect each
# tiny forms: on the tiny-test config's 256x320 canvas the token grid is
# 16x20, which windows of 6 pad to 18x24
TINY_VITS = {
    "vit_smoke": ("vit", dict(dim=32, depth=4, num_heads=2, mlp_dim=64, global_idx=(1, 3),
                              rope=False, swiglu=False, window_size=6)),
    "eva_02_vit_smoke": ("vit", dict(dim=32, depth=4, num_heads=2, mlp_dim=48,
                                     global_idx=(1, 3), rope=True, swiglu=True, window_size=6)),
}
# the R50-DCN's conv2 samplers on the 800x1344 canvas: (label, map (H, W,
# C), output (oh, ow), stride, blocks at this shape a forward)
DCN_SAMPLERS = (
    ("layer2.0", (200, 336, 128), (100, 168), 2, 1),
    ("layer2.1-3", (100, 168, 128), (100, 168), 1, 3),
    ("layer3.0", (100, 168, 256), (50, 84), 2, 1),
    ("layer3.1-5", (50, 84, 256), (50, 84), 1, 5),
    ("layer4.0", (50, 84, 512), (25, 42), 2, 1),
    ("layer4.1-2", (25, 42, 512), (25, 42), 1, 2),
)
SAMPLER_ITERS = 20
SAMPLER_PLAIN_ITERS = 5
# the sampler's gradients against the plain backward, each in units of its
# max: the map gradient's float atomics add in another order than
# scatter_add_, and the point gradient sums C products in another order
TOL_SAMPLER_GRAD = 1e-5
# the first sampler kernels' wrapper ms (CUDA events, host time included)
# at DCN_SAMPLERS, forward and backward, from an earlier run of this script
# on an NVIDIA H100 80GB HBM3 at 700 W (PERF.md §6): printed beside this
# run's wrapper ms, labelled so, and set against no device ms
FIRST_SAMPLER_MS = {
    "layer2.0": (0.0731, 0.1507), "layer2.1-3": (0.0641, 0.1256), "layer3.0": (0.0331, 0.0760),
    "layer3.1-5": (0.0466, 0.0659), "layer4.0": (0.0454, 0.0541), "layer4.1-2": (0.0471, 0.0542),
}
# the wide case at layer2.0: tap offsets of N(0, SAMPLER_WIDE_SIGMA) pixels,
# and every SAMPLER_FAR-th sample far off the map, NaN or on an edge
SAMPLER_WIDE_SIGMA = 8.0
SAMPLER_FAR = 97
# torch.profiler sessions a sampler shape gets at most before phase 10 gives
# up on its device time (a session now and then sees no device activity)
SAMPLER_PROFILE_TRIES = 4
NMS_THRESHOLD = 0.7
NMS_ITERS = 20


def sampler_inputs(torch, gen, hwc, out_hw, stride):
    """A (1, H, W, C) map and the 3x3 taps of every output position at
    ``stride`` with offsets of N(0, 1.5) pixels, as a DCN samples them."""
    (h, w, c), (oh, ow) = hwc, out_hw
    feat = torch.randn(1, h, w, c, device="cuda", generator=gen)
    taps = torch.arange(3, device="cuda") - 1
    ys = (torch.arange(oh, device="cuda") * stride)[:, None, None, None] + taps[:, None]
    xs = (torch.arange(ow, device="cuda") * stride)[None, :, None, None] + taps
    grid = torch.stack(torch.broadcast_tensors(xs, ys), -1).reshape(1, -1, 2).float()
    return feat, grid + torch.randn(grid.shape, device="cuda", generator=gen) * 1.5


def sampler_wide_inputs(torch, gen):
    """layer2.0's map and taps with offsets of N(0, SAMPLER_WIDE_SIGMA)
    pixels; among every SAMPLER_FAR samples one far off the map, one past
    int32 (its floor saturates), one with x NaN, one all NaN and one half a
    pixel off the bottom-left corner."""
    label, hwc, out_hw, stride, _ = DCN_SAMPLERS[0]
    feat, points = sampler_inputs(torch, gen, hwc, out_hw, stride)
    extra = SAMPLER_WIDE_SIGMA ** 2 - 1.5 ** 2
    points = points + torch.randn(points.shape, device="cuda", generator=gen) * extra ** 0.5
    k = SAMPLER_FAR
    points[0, ::k] = torch.tensor([-1e4, 5.0], device="cuda")
    points[0, 1::k] = torch.tensor([3e9, -3e9], device="cuda")
    points[0, 2::k, 0] = float("nan")
    points[0, 3::k] = float("nan")
    points[0, 4::k] = torch.tensor([-0.5, hwc[0] - 0.5], device="cuda")
    return f"{label} wide", hwc, feat, points


def sampler_errors(torch, label, got, want, got_grads, want_grads):
    """The forward's max abs error (within TOL_KERNEL of its max) and each
    gradient's (map, points) max abs error and its share of the max (within
    TOL_SAMPLER_GRAD), NaN exactly where the plain version has NaN."""
    def errors(name, g, w, tol):
        if not torch.equal(torch.isnan(g), torch.isnan(w)):
            raise AssertionError(f"bilinear_sample {label}: {name} NaN where the plain version "
                                 "has none, or none where it has NaN")
        err = (g - w).nan_to_num().abs().max().item()
        scale = w.nan_to_num().abs().max().item()
        if not err <= tol * max(scale, 1.0 if name == "output" else 0.0):
            raise AssertionError(f"bilinear_sample {label}: {name} off by {err} (max {scale})")
        return err, err / scale if scale else 0.0

    err = errors("output", got, want, TOL_KERNEL)[0]
    grad = [errors(f"{name} gradient", g, w, TOL_SAMPLER_GRAD)
            for name, g, w in zip(("map", "points"), got_grads, want_grads)]
    return err, [e for e, _ in grad], [r for _, r in grad]


def sampler_calls(gs, feat, points, grad_out, n=SAMPLER_ITERS):
    """n forward and n backward calls through the wrappers (a profiled run)."""
    for _ in range(n):
        gs.bilinear_sample(feat, points)
        gs.bilinear_sample_backward(feat, points, grad_out)


def check_bilinear_sample(torch, kernels, dcn):
    """Phase 12 (c): ``csrc/grid_sample.cu``'s ``bilinear_sample_fwd`` and
    ``bilinear_sample_bwd`` against their plain versions
    (``bilinear_sample_reference``, ``bilinear_sample_backward_reference``)
    on the card at each of the R50-DCN's conv2 shapes (DCN_SAMPLERS) and at
    a wide case at layer2.0 (``sampler_wide_inputs``: far-off, saturating
    and NaN points): the output within TOL_KERNEL of its max, each gradient
    (map and points) within TOL_SAMPLER_GRAD of its max, NaN exactly where
    the plain version has it; CUDA-event times of the wrappers and the plain
    versions in turns with one ``F.grid_sample`` call (align_corners=True
    on the pixel grid: the same function, NCHW), forward and backward,
    beside the bounds and the first kernels' wrapper times from an earlier
    run (FIRST_SAMPLER_MS); each
    shape's 20 forward and 20 backward calls profiled in phase 10
    (``report_bilinear_sample`` prints the device ms a launch); then the
    kernels' sum over a forward's 13 DCNs as a share of the R50-DCN detect
    p50, and forward + backward of its step p50 (``dcn``: run_large_model's
    numbers, whose launches fill the kernel rows). Bytes: the map, points
    and output once (backward: the output gradient, map and points read,
    their gradients written); operations: 4 corners x C FMAs a sample
    forward, 3x that backward."""
    import torch.nn.functional as F

    from relation_detr_tpu_torch.ops import grid_sample as gs

    gen = torch.Generator(device="cuda").manual_seed(21)
    rows = []
    work = dict(fwd_bytes=0, fwd_ops=0, bwd_bytes=0, bwd_ops=0)  # a forward's DCNs, summed
    def cases():  # drawn lazily: each case's inputs, then its grad_out
        for label, hwc, out_hw, stride, count in DCN_SAMPLERS:
            yield (label, hwc, *sampler_inputs(torch, gen, hwc, out_hw, stride), count)
        yield (*sampler_wide_inputs(torch, gen), 0)

    for label, hwc, feat, points, count in cases():
        grad_out = torch.randn(points.shape[:2] + hwc[2:], device="cuda", generator=gen)
        out = gs.bilinear_sample(feat, points)
        want = gs.bilinear_sample_reference(feat, points)
        grads = gs.bilinear_sample_backward(feat, points, grad_out)
        want_grads = gs.bilinear_sample_backward_reference(feat, points, grad_out)
        torch.cuda.synchronize()
        err, grad_err, grad_rel = sampler_errors(torch, label, out, want, grads, want_grads)
        h, w, c = hwc
        n = points.shape[1]
        fwd_work = (size(feat, points, out), 8 * n * c)
        bwd_work = (size(grad_out, feat, points) + size(feat, points), 24 * n * c)
        fwd_bound, bwd_bound = bound(*fwd_work), bound(*bwd_work)
        row = dict(shape=label, map=list(hwc), samples=n, count=count, max_abs_err=err,
                   grad_max_abs_err=grad_err, grad_rel_err=grad_rel,
                   fwd_bound_ms=fwd_bound[0], fwd_bound_by=fwd_bound[1],
                   bwd_bound_ms=bwd_bound[0], bwd_bound_by=bwd_bound[1])
        plain = (lambda: gs.bilinear_sample_reference(feat, points),
                 lambda: gs.bilinear_sample_backward_reference(feat, points, grad_out))
        kernel = (lambda: gs.bilinear_sample(feat, points),
                  lambda: gs.bilinear_sample_backward(feat, points, grad_out))
        if count:  # an R50-DCN shape: beside F.grid_sample
            nchw = feat.permute(0, 3, 1, 2).contiguous()
            grid = (points / torch.tensor([w - 1, h - 1], device="cuda") * 2 - 1)[:, :, None]
            lib = F.grid_sample(nchw, grid, "bilinear", "zeros", align_corners=True)
            row["library_max_abs_diff"] = (lib[..., 0].permute(0, 2, 1) - out).abs().max().item()
            row["fwd_ms"], row["plain_fwd_ms"], row["library_fwd_ms"] = in_turns(
                plain[0], kernel[0], SAMPLER_PLAIN_ITERS, SAMPLER_ITERS,
                lambda: F.grid_sample(nchw, grid, "bilinear", "zeros", align_corners=True))
            nchw_g, grid_g = nchw.requires_grad_(True), grid.requires_grad_(True)
            lib_out = F.grid_sample(nchw_g, grid_g, "bilinear", "zeros", align_corners=True)
            lib_grad = grad_out.permute(0, 2, 1)[..., None]
            row["bwd_ms"], row["plain_bwd_ms"], row["library_bwd_ms"] = in_turns(
                plain[1], kernel[1], SAMPLER_PLAIN_ITERS, SAMPLER_ITERS,
                lambda: torch.autograd.grad(lib_out, (nchw_g, grid_g), lib_grad,
                                            retain_graph=True))
            for key, value in zip(work, fwd_work + bwd_work):
                work[key] += value * count
            del nchw, grid, lib, lib_out, nchw_g, grid_g
        else:
            row["fwd_ms"], row["plain_fwd_ms"] = in_turns(
                plain[0], kernel[0], SAMPLER_PLAIN_ITERS, SAMPLER_ITERS)
            row["bwd_ms"], row["plain_bwd_ms"] = in_turns(
                plain[1], kernel[1], SAMPLER_PLAIN_ITERS, SAMPLER_ITERS)
        PROFILES.append((f"bilinear_sample {label} x{SAMPLER_ITERS}, forward and backward",
                         lambda args=(feat, points, grad_out): sampler_calls(gs, *args),
                         ("bilinear_fwd_kernel", "bilinear_bwd_kernel", "Memset"), row, "device"))
        rows.append(row)
        first = FIRST_SAMPLER_MS.get(label)
        phase(12, f"bilinear_sample {label} ({h}x{w}x{c} at {n} points, {count} a forward): "
                  f"forward max abs err {err:.3e}, wrapper {row['fwd_ms']:.4f} ms"
                  + (f" (first kernels' wrapper, earlier run: {first[0]:.4f})" if first else "")
                  + f", plain {row['plain_fwd_ms']:.4f} ms"
                  + (f", F.grid_sample {row['library_fwd_ms']:.4f} ms (max abs diff "
                     f"{row['library_max_abs_diff']:.3e})" if count else "")
                  + f", bound {fwd_bound[0]:.4f} ms ({fwd_bound[1]}); backward max abs err map "
                  f"{grad_err[0]:.3e} points {grad_err[1]:.3e} (of their max: {grad_rel[0]:.2e}, "
                  f"{grad_rel[1]:.2e}), wrapper {row['bwd_ms']:.4f} ms"
                  + (f" (first kernels' wrapper, earlier run: {first[1]:.4f})" if first else "")
                  + f", plain {row['plain_bwd_ms']:.4f} ms"
                  + (f", F.grid_sample's {row['library_bwd_ms']:.4f} ms" if count else "")
                  + f", bound {bwd_bound[0]:.4f} ms ({bwd_bound[1]})")
        del out, want, grads, want_grads
    shapes = [r for r in rows if r["count"]]
    totals = {key: sum(r[key] * r["count"] for r in shapes)
              for key in ("fwd_ms", "plain_fwd_ms", "library_fwd_ms", "bwd_ms", "plain_bwd_ms",
                          "library_bwd_ms")}
    fwd_bound = bound(work["fwd_bytes"], work["fwd_ops"])
    bwd_bound = bound(work["bwd_bytes"], work["bwd_ops"])
    fwd, bwd = totals["fwd_ms"], totals["bwd_ms"]
    shares = dict(forward_ms_per_detect=fwd, detect_share=fwd / dcn["detect_ms_p50"],
                  fwd_bwd_ms_per_step=fwd + bwd, step_share=(fwd + bwd) / dcn["step_ms_p50"])
    common = dict(route="cuda", source="relation_detr_tpu_torch/csrc/grid_sample.cu",
                  replaces="relation_detr_tpu/ops/grid_sample.py:11",
                  shape=f"the R50-DCN forward's {sum(r['count'] for r in shapes)} DCN samplers "
                        "(DCN_SAMPLERS), each shape's time times its count, summed",
                  library="F.grid_sample(align_corners=True) on the NCHW map")
    # launches: the R50-DCN train steps'; eval_launches: its detects'
    kernels["bilinear_sample"] = dict(
        common, name="bilinear_sample_fwd",
        launches=dcn["train_launches"]["bilinear_sample_fwd"],
        eval_launches=dcn["eval_launches"]["bilinear_sample_fwd"],
        max_abs_err=max(r["max_abs_err"] for r in rows), ms=fwd, plain_ms=totals["plain_fwd_ms"],
        bound_ms=fwd_bound[0], bound_by=fwd_bound[1], library_ms=totals["library_fwd_ms"])
    kernels["bilinear_sample_bwd"] = dict(
        common, name="bilinear_sample_bwd",
        launches=dcn["train_launches"]["bilinear_sample_bwd"],
        eval_launches=dcn["eval_launches"]["bilinear_sample_bwd"],
        max_abs_err=max(max(r["grad_max_abs_err"]) for r in rows), ms=bwd,
        plain_ms=totals["plain_bwd_ms"], bound_ms=bwd_bound[0], bound_by=bwd_bound[1],
        library_ms=totals["library_bwd_ms"])
    first = [sum(FIRST_SAMPLER_MS[r["shape"]][i] * r["count"] for r in shapes) for i in (0, 1)]
    phase(12, f"bilinear_sample over a forward's {sum(r['count'] for r in shapes)} DCNs "
              f"({dcn['dcns']} DCN modules; launches: detects {dcn['eval_launches']}, train "
              f"steps {dcn['train_launches']}): forward {fwd:.3f} ms by the wrapper (first "
              f"kernels' wrapper, earlier run: {first[0]:.3f}, plain "
              f"{totals['plain_fwd_ms']:.3f}, F.grid_sample {totals['library_fwd_ms']:.3f}, "
              f"bound {fwd_bound[0]:.4f}), "
              f"{100 * shares['detect_share']:.2f}% of the R50-DCN detect p50 "
              f"{dcn['detect_ms_p50']:.3f} ms; backward {bwd:.3f} ms by the wrapper (first "
              f"kernels' wrapper, earlier run: {first[1]:.3f}, plain "
              f"{totals['plain_bwd_ms']:.3f}, F.grid_sample's {totals['library_bwd_ms']:.3f}, "
              f"bound {bwd_bound[0]:.4f}); forward + backward "
              f"{fwd + bwd:.3f} ms, {100 * shares['step_share']:.2f}% of its step p50 "
              f"{dcn['step_ms_p50']:.3f} ms")
    return dict(rows=rows, totals=totals, **shares)


def report_bilinear_sample(sampler, kernels, torch):
    """Phase 10, after the profiles: each phase-12 (c) shape's device ms a
    launch of ``bilinear_fwd_kernel`` and of ``bilinear_bwd_kernel`` with
    the map gradient's zeroing (torch.profiler over 20 calls each) beside
    its wrapper ms, bound, ``F.grid_sample``, plain version and the first
    kernels' wrapper ms from an earlier run; a forward's 13 DCNs summed into
    the kernel rows' ``device_ms``. A shape whose session missed one of the
    three (the kernels, the zeroing) is profiled again, up to
    SAMPLER_PROFILE_TRIES sessions in all; if one is still missing, this
    raises, so that no row sums a shape that was not measured."""
    names = ("bilinear_fwd_kernel", "bilinear_bwd_kernel", "Memset")
    fns = {id(row): fn for _, fn, _, row, _ in PROFILES}

    def launches(found, name):
        return sum(n for key, (_, n) in (found or {}).items() if name in key)

    def measured(found):
        return all(launches(found, name) for name in names)

    device = {"fwd": 0.0, "bwd": 0.0}
    for row in sampler["rows"]:
        found, tries = row.get("device"), SAMPLER_PROFILE_TRIES - 2  # run_profiles took two
        fn = fns[id(row)]
        while not measured(found) and tries > 0:
            found, tries = profile_kernels(torch, fn, names), tries - 1
        if not measured(found):
            raise AssertionError(f"bilinear_sample {row['shape']}: torch.profiler missed its "
                                 f"kernels or zeroing in {SAMPLER_PROFILE_TRIES} sessions")
        row["device"] = found
        # ms a launch over the launches the profiler saw (it may miss the
        # first); the backward's with the map gradient's zeroing
        per_launch = {name: sum(ms for key, (ms, _) in found.items() if name in key)
                      / max(launches(found, name), 1) for name in names}
        row["device_zeroing_ms"] = per_launch["Memset"]
        row["device_fwd_ms"] = per_launch["bilinear_fwd_kernel"]
        row["device_bwd_ms"] = per_launch["bilinear_bwd_kernel"] + per_launch["Memset"]
        for kind in ("fwd", "bwd"):
            device[kind] += row[f"device_{kind}_ms"] * row["count"]
        first = FIRST_SAMPLER_MS.get(row["shape"], ("-", "-"))
        lib = [row.get(f"library_{k}_ms") for k in ("fwd", "bwd")]
        phase(10, f"bilinear_sample {row['shape']}: " + "; ".join(
            f"{kind} device {row[f'device_{kind}_ms']:.4f} ms a launch"
            + (f" (zeroing {row['device_zeroing_ms']:.4f})" if kind == "bwd" else "")
            + f", wrapper {row[f'{kind}_ms']:.4f}, bound {row[f'{kind}_bound_ms']:.4f}, "
            "F.grid_sample " + (f"{lib[i]:.4f}" if lib[i] is not None else "-")
            + f", plain {row[f'plain_{kind}_ms']:.4f}, first kernels' wrapper (earlier run) "
            f"{first[i]}" for i, kind in enumerate(("fwd", "bwd"))))
    kernels["bilinear_sample"]["device_ms"] = device["fwd"]
    kernels["bilinear_sample_bwd"]["device_ms"] = device["bwd"]
    dcns = sum(r["count"] for r in sampler["rows"])
    phase(10, f"bilinear_sample over a forward's {dcns} DCNs, device: forward "
              f"{device['fwd']:.4f} ms, backward {device['bwd']:.4f} ms")


def check_nms(torch, model):
    """Phase 12 (c): ``ops.nms.nms_mask`` (plain PyTorch on the card: the
    greedy rule's fixed point, one scalar read a pass) on the flagship's
    detect outputs (``model``: phase 5's, seeded weights) at B=1 and B=2:
    ``post_process(..., 300, nms_iou_threshold=0.7)`` whose valid mask must
    be the top-k's keep mask, the keep mask equal to the CPU's on the same
    boxes and scores, CUDA-event times of ``nms_mask`` alone and of
    ``post_process`` with and without NMS, and the bound (the boxes,
    scores and mask once; about 20 operations an IoU pair)."""
    from relation_detr_tpu_torch.models.post_process import post_process
    from relation_detr_tpu_torch.ops.nms import nms_mask

    gen = torch.Generator(device="cuda").manual_seed(22)
    requests = [family_request(torch, gen, h, w) for h, w in REQUESTS[:2]]
    rows = []
    for bs in (1, 2):
        images = torch.cat([r[0] for r in requests[:bs]])
        mask = torch.cat([r[1] for r in requests[:bs]])
        sizes = torch.tensor([r[2][0] for r in requests[:bs]], dtype=torch.float32,
                             device="cuda")
        with torch.inference_mode():
            raw = model(images, mask)
            logits, boxes = raw["pred_logits"], raw["pred_boxes"]
            plain = post_process(logits, boxes, sizes, 300)
            det = post_process(logits, boxes, sizes, 300, nms_iou_threshold=NMS_THRESHOLD)
            keep = nms_mask(plain["boxes"], plain["scores"], NMS_THRESHOLD)
            cpu_keep = nms_mask(plain["boxes"].cpu(), plain["scores"].cpu(), NMS_THRESHOLD)
            if not torch.equal(keep.cpu(), cpu_keep) or not torch.equal(det["valid"], keep):
                raise AssertionError(f"nms_mask B={bs}: the card's keep mask is not the CPU's "
                                     "or post_process's valid mask")
            nms_ms = cuda_ms(lambda: nms_mask(plain["boxes"], plain["scores"], NMS_THRESHOLD),
                             NMS_ITERS)
            pp_ms = cuda_ms(lambda: post_process(logits, boxes, sizes, 300), NMS_ITERS)
            pp_nms_ms = cuda_ms(lambda: post_process(logits, boxes, sizes, 300,
                                                     nms_iou_threshold=NMS_THRESHOLD), NMS_ITERS)
        n = plain["scores"].shape[1]
        nms_bound = bound(size(plain["boxes"], plain["scores"], keep), 20 * bs * n * n)
        kept = keep.sum(1).tolist()
        rows.append(dict(batch=bs, n=n, kept=kept, ms=nms_ms, bound_ms=nms_bound[0],
                         bound_by=nms_bound[1], post_process_ms=pp_ms,
                         post_process_nms_ms=pp_nms_ms))
        phase(12, f"nms_mask B={bs} N={n} IoU > {NMS_THRESHOLD} on the flagship's detect "
                  f"outputs: kept {kept}, keep mask equal to the CPU's and post_process's valid "
                  f"mask; {nms_ms:.4f} ms (bound {nms_bound[0]:.6f}, {nms_bound[1]}); "
                  f"post_process {pp_ms:.4f} ms, with NMS {pp_nms_ms:.4f} ms")
    return rows


def run_vit_dcn(torch, kernels, flagship):
    """Phase 12: (a) the tiny ViT, EVA-02 and DCN ResNet-18 on the tiny-test
    config, GPU against CPU, eval and one train step; (b) VIT_DCN_MODELS at
    full width (``run_large_model``), VIT_DCN_BF16 also under the bf16
    policy; (c) ``bilinear_sample`` and ``nms_mask`` timed on the card
    (``flagship``: phase 5's model)."""
    register_tiny_backbones(TINY_VITS)
    smi = _run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"])
    results = {"card": smi, "tiny": {}}
    for arch in TINY_VITS:
        results["tiny"][arch] = check_tiny_backbone_eval(torch, arch, n=12)
        check_tiny_train(torch, "gather", {}, None, n=12, backbone=arch)
    results["tiny"]["resnet18_dcn"] = check_tiny_backbone_eval(torch, "resnet18", n=12,
                                                               dcn=DCN_STAGES)
    check_tiny_train(torch, "gather", {}, None, n=12, backbone="resnet18", dcn=DCN_STAGES)
    for label, overrides in VIT_DCN_MODELS.items():
        results[label], model, request = run_large_model(torch, label, kernels, overrides,
                                                         n=12)
        if label in VIT_DCN_BF16:
            results[label]["bf16"] = check_bf16_backbone(torch, label, model, request,
                                                         overrides, n=12)
        del model, request
        torch.cuda.empty_cache()
    results["bilinear_sample"] = check_bilinear_sample(torch, kernels, results["r50_dcn"])
    results["nms_mask"] = check_nms(torch, flagship)
    phase(12, f"[{smi}] " + "; ".join(
        f"{k}: detect p50 {results[k]['detect_ms_p50']:.3f} ms, "
        f"{results[k]['detect_peak_gib']:.3f} GiB, step p50 {results[k]['step_ms_p50']:.3f} ms, "
        f"{results[k]['step_peak_gib']:.3f} GiB" for k in VIT_DCN_MODELS))
    return results



# phase 13, data parallelism: the flagship on 2 processes. Where the
# machine has 2 cards they run under NCCL, one a card; on one card they share
# it under gloo, whose collectives take tensors on the card through host
# memory (NCCL refuses two processes on one card).
DP_WORLD = 2
DP_TIMED = (1, 5)  # warm-up and timed steps after the checked one (2 processes, and B=2 alone)
DP_TIMEOUT_S = 120.0  # a collective that waits longer fails the process, and the phase
DP_GT_CAP = 100
# the 2-process step at B=1 a process against one process at B=2, on the same
# weights, images, denoising draws and (pinned) two-stage top-k: each loss
# term relative; grad_norm relative (a ReLU input within rounding of 0 that
# B=1 and B=2 convolutions round to other sides moves a few gradients, PERF.md
# §6); the parameters after one AdamW update: AdamW's first update is about
# lr * sign(g), so an element whose gradient is within noise of 0 may move by
# up to 2 lr; at most this share of elements may differ by more than lr / 1000
TOL_DP_LOSS = 1e-4
TOL_DP_NORM = 1e-3
TOL_DP_SHARE = 1e-3


def dp_options(torch):
    """The phase's backend and cards: NCCL on 2 cards where there are 2,
    else gloo with both processes on card 0."""
    two = torch.cuda.device_count() >= DP_WORLD
    return dict(backend="nccl" if two else "gloo", device="cuda", config=FLAGSHIP,
                canvas=CANVAS, coco=os.path.join(ROOT, EVAL_DATA, "synth_coco"),
                cards="one card per process" if two else "both processes on card 0")


def dp_config_path(opts):
    return os.path.join(ROOT, "relation_detr_tpu_torch", "configs", "relation_detr",
                        opts["config"] + ".py")


def dp_flagship_step(torch, opts, device):
    """The flagship (seed 0) in train mode on ``device``, its AdamW (the
    train config's) and its train step."""
    from relation_detr_tpu_torch.configs import train_config
    from relation_detr_tpu_torch.parallel.train_step import make_train_step
    from relation_detr_tpu_torch.utils.param_groups import build_optimizer

    cfg = importlib.import_module(CONFIGS + opts["config"])
    model = cfg.build_model(device=device, seed=0).train()
    optimizer = build_optimizer(model, train_config.learning_rate,
                                weight_decay=train_config.weight_decay,
                                betas=train_config.betas, max_norm=train_config.max_norm)
    step = make_train_step(model, cfg.build_criterion(), optimizer, cfg.hybrid_assign, seed=0)
    return model, optimizer, step


def dp_inject(model, draws):
    """The denoising draws of the whole global batch, on the model's device
    (the step takes its process's rows)."""
    model.denoising_generator.draw_noise = lambda bs, gen, dev: {
        k: v.to(dev) for k, v in draws.items()}


def dp_inputs(torch, opts, bs, seed):
    """A global batch (BOXES_PER_IMAGE boxes an image, GT capacity
    DP_GT_CAP) and its denoising draws, on the CPU."""
    cfg = importlib.import_module(CONFIGS + opts["config"])
    gen = torch.Generator().manual_seed(seed)
    batch = synthetic_batch(torch, gen, bs, DP_GT_CAP, opts["canvas"], "cpu",
                            (opts["canvas"][0], opts["canvas"][1] - 64))
    batch["gt_labels"][:, :BOXES_PER_IMAGE] %= cfg.num_classes
    dn_cap = 2 * cfg.model_args.get("denoising_nums", 100)
    draws = {"flip_u": torch.rand(bs, dn_cap, generator=gen),
             "random_labels": torch.randint(0, cfg.num_classes, (bs, dn_cap), generator=gen),
             "rand_sign": torch.randint(0, 2, (bs, dn_cap, 4), generator=gen).float() * 2 - 1,
             "rand_part": torch.rand(bs, dn_cap, 4, generator=gen)}
    return batch, draws


def dp_params(model):
    """The trainable parameters, flattened, on the CPU."""
    import torch

    return torch.cat([p.detach().reshape(-1).cpu() for p in model.parameters()
                      if p.requires_grad])


def dp_param_diff(got, want, lr):
    """(max |got - want|, share of elements apart by more than lr / 1000)."""
    diff = (got - want).abs()
    return float(diff.max()), float((diff > lr * 1e-3).double().mean())


def dp_losses_err(got, want):
    """The largest relative difference over the loss terms and the total."""
    keys = [k for k in want if k.startswith("loss") or k == "total_loss"]
    if set(keys) - set(got):
        raise AssertionError(f"loss terms missing: {sorted(set(keys) - set(got))}")
    return max(abs(got[k] - want[k]) / max(abs(want[k]), 1e-12) for k in keys)


def dp_counters():
    from relation_detr_tpu_torch.ops import msda, relation_bias

    return {"msda_fwd": msda.multi_scale_deformable_attention, "msda_bwd": msda.msda_backward,
            "relation_bias_v4_fwd": relation_bias.relation_bias_v4}


def dp_timed_steps(torch, step, batch, n):
    """Runs n steps; each one's ms (CUDA events), its losses finite."""
    times = []
    for _ in range(n):
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        metrics = step(batch)
        end.record()
        torch.cuda.synchronize()
        if not math.isfinite(metrics["total_loss"]) or metrics["nonfinite_count"]:
            raise AssertionError(f"data-parallel step: non-finite metrics {metrics}")
        times.append(start.elapsed_time(end))
    return times


def dp_rank(torch, opts, rank, device, tmp):
    """One process of the phase: the checked step (top-k pinned to the
    one-process run's rows of this process's image), warm-up and timed
    steps with every counter at 0 before them, then the train CLI for an
    epoch with an evaluation, a --resume of it, and the eval CLI."""
    from relation_detr_tpu_torch import test as eval_cli
    from relation_detr_tpu_torch import train
    from relation_detr_tpu_torch.parallel import mesh

    inputs = torch.load(os.path.join(tmp, "inputs.pt"), weights_only=True)
    out = {"device": str(device), "name": torch.cuda.get_device_name(device),
           "backend": mesh.backend_name()}
    model, optimizer, step = dp_flagship_step(torch, opts, device)
    dp_inject(model, inputs["draws"])
    batch = {k: v[rank:rank + 1].to(device) for k, v in inputs["batch"].items()}
    counters = dp_counters()
    for fn in counters.values():
        fn.launches = 0
    pins = [[None, None, idx[rank:rank + 1]] for idx in inputs["topk"]]
    with PinnedTopk(pins):
        out["metrics"] = step(batch)
    torch.cuda.synchronize()
    if rank == 0:
        out["params"] = dp_params(model)
    out["digest"] = torch.stack([p.detach().double().sum() for p in model.parameters()]).cpu()
    out["step_ms"] = dp_timed_steps(torch, step, batch, sum(DP_TIMED))[DP_TIMED[0]:]
    out["reduce_ms"] = step.reduce_ms()[1 + DP_TIMED[0]:]
    out["launches"] = {k: fn.launches for k, fn in counters.items()}
    out["steps"] = 1 + sum(DP_TIMED)
    out["peak_gib"] = torch.cuda.max_memory_allocated(device) / 2**30
    del model, optimizer, step, batch
    torch.cuda.empty_cache()

    args = ["--coco-path", opts["coco"], "--batch-size", "1", "--canvas",
            f"{opts['canvas'][0]},{opts['canvas'][1]}", "--seed", "0", "--device", "cuda",
            "--model-config", dp_config_path(opts)]
    first_dir, resumed_dir = os.path.join(tmp, "train"), os.path.join(tmp, "resumed")
    t0 = time.perf_counter()
    got = train.main(args + ["--output-dir", first_dir, "--num-epochs", "1",
                             "--eval-every-epochs", "1"])
    out["train_cli"] = dict(seconds=time.perf_counter() - t0, steps=len(got["steps"]),
                            images=got["images"], evals=got["evals"],
                            step_ms=[s["step"] for s in got["steps"]],
                            total_loss=got["metrics"]["total_loss"],
                            checkpoints=sorted(os.listdir(os.path.join(first_dir, "checkpoints"))),
                            weights=sorted(f for f in os.listdir(first_dir)
                                           if f.endswith(".npz")))
    t0 = time.perf_counter()
    got = train.main(args + ["--output-dir", resumed_dir, "--num-epochs", "2", "--resume",
                             first_dir, "--max-steps", "2"])
    out["resume"] = dict(seconds=time.perf_counter() - t0, steps=len(got["steps"]),
                         epochs=sorted({s["epoch"] for s in got["steps"]}),
                         total_loss=got["metrics"]["total_loss"],
                         checkpoints=sorted(os.listdir(os.path.join(resumed_dir,
                                                                    "checkpoints"))))
    got = eval_cli.main(["--coco-path", opts["coco"], "--batch-size", str(EVAL_BATCH),
                         "--device", "cuda", "--result-json", os.path.join(tmp, "eval.json"),
                         "--model-config", args[-1]])
    out["eval_cli"] = dict(stats=got["stats"], images=got["images"], seconds=got["seconds"])
    return out


def dp_process(rank, opts, tmp):
    """A spawned process of phase 13: joins the group, runs ``dp_rank`` and
    writes its result; an exception fails the process, and the phase."""
    import torch

    from relation_detr_tpu_torch.parallel import mesh

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    device = mesh.init_distributed(opts["backend"], opts["device"],
                                   init_method=f"file://{tmp}/rendezvous", rank=rank,
                                   world_size=DP_WORLD, local_rank=rank, timeout_s=DP_TIMEOUT_S)
    try:
        out = dp_rank(torch, opts, rank, device, tmp)
    finally:
        mesh.destroy()
    torch.save(out, os.path.join(tmp, f"rank{rank}.pt"))


def check_world_one(torch, opts, tmp):
    """Phase 13 (a): the flagship in this process under a NCCL group of one
    process against no group: an eval batch (bit-identical: no collective
    runs and the forward has no atomics) and two train steps (the first's
    losses bit-identical, the second's, on the first run's two-stage top-k,
    and the parameters after within msda_bwd's atomics noise)."""
    from relation_detr_tpu_torch.configs import train_config
    from relation_detr_tpu_torch.parallel import mesh
    from relation_detr_tpu_torch.utils.evaluation import make_detections_fn

    batch, draws = dp_inputs(torch, opts, 1, 21)
    batch = {k: v.to("cuda") for k, v in batch.items()}
    sizes = torch.tensor([[opts["canvas"][0], opts["canvas"][1] - 64]], dtype=torch.float32,
                         device="cuda")

    def run(topk=None):
        model, optimizer, step = dp_flagship_step(torch, opts, "cuda")
        dp_inject(model, draws)
        model.eval()
        det = make_detections_fn(model, 300)(batch["images"], batch["mask"], sizes).cpu()
        model.train()
        with TopkRecorder() if topk is None else PinnedTopk(topk) as rec:
            metrics = [step(batch)]
            params = [dp_params(model)]
            metrics.append(step(batch))
            params.append(dp_params(model))
        del model, optimizer, step
        torch.cuda.empty_cache()
        return det, metrics, params, getattr(rec, "indices", None)

    alone = run()
    mesh.init_distributed("nccl", "cuda", init_method=f"file://{tmp}/world_one", rank=0,
                          world_size=1, local_rank=0, timeout_s=DP_TIMEOUT_S)
    try:
        if (mesh.backend_name(), mesh.world(), mesh.active()) != ("nccl", (0, 1), False):
            raise AssertionError(f"world-one group: {mesh.backend_name()} {mesh.world()}")
        # the second step's two-stage top-k taken from the first run: msda_bwd's
        # atomics move the first update by rounding, which can swap near-equal
        # proposals at the k-th place and send the second step's losses elsewhere
        grouped = run(alone[3])
    finally:
        mesh.destroy()
    if not torch.equal(grouped[0], alone[0]):
        raise AssertionError("NCCL world size 1: the eval batch's detections differ from no "
                             "group's")
    first = [{k: v for k, v in m.items() if k.startswith("loss") or k == "total_loss"}
             for m in (grouped[1][0], alone[1][0])]
    if first[0] != first[1]:
        raise AssertionError("NCCL world size 1: the first step's losses differ from no "
                             "group's")
    norm_err = abs(grouped[1][0]["grad_norm"] - alone[1][0]["grad_norm"]) / \
        alone[1][0]["grad_norm"]
    loss_err = dp_losses_err(grouped[1][1], alone[1][1])
    (top, share), (top2, share2) = (dp_param_diff(g, a, train_config.learning_rate)
                                    for g, a in zip(grouped[2], alone[2]))
    if loss_err > TOL_DP_LOSS or norm_err > TOL_DP_NORM or share > TOL_DP_SHARE:
        raise AssertionError(f"NCCL world size 1: second step's losses {loss_err:.3e} rel from "
                             f"no group's, first grad_norm {norm_err:.3e} rel, parameters "
                             f"after the first update {share:.3e} of elements apart")
    phase(13, f"(a) flagship under a NCCL group of one process vs no group: eval batch's 300 "
              f"detections bit-identical, first step's {len(first[0])} losses bit-identical "
              f"and grad_norm within {norm_err:.3e} rel (tolerance {TOL_DP_NORM:g}), second "
              f"step's losses (top-k pinned) within {loss_err:.3e} rel (tolerance "
              f"{TOL_DP_LOSS:g}); parameters after the first update max |diff| {top:.3e}, "
              f"{share:.3e} of elements apart by more than lr/1000 (tolerance "
              f"{TOL_DP_SHARE:g}; msda_bwd's atomics), after the second {top2:.3e}, "
              f"{share2:.3e} (not held: AdamW's second update moves a gradient within "
              f"rounding of eps by up to lr)")
    return dict(first_grad_norm_rel=norm_err, second_step_loss_rel=loss_err,
                params_max_abs=top, params_share=share, params_max_abs_2=top2,
                params_share_2=share2)


def run_data_parallel(torch, kernels):
    """Phase 13: (a) ``check_world_one``; (b) the one-process B=2 step with
    its top-k recorded, then timed, and the eval CLI alone; (c) two
    spawned processes (``dp_process``): the checked step against (b)'s,
    timed steps and the all-reduce's span, the train CLI (one checkpoint,
    a resume) and the eval CLI (the same 12 stats as alone)."""
    import gc
    import tempfile

    from relation_detr_tpu_torch import test as eval_cli
    from relation_detr_tpu_torch.configs import train_config

    opts = dp_options(torch)
    lr = train_config.learning_rate
    t_phase = time.perf_counter()
    result = {"backend": opts["backend"], "cards": opts["cards"], "world": DP_WORLD}
    with tempfile.TemporaryDirectory() as tmp:
        result["world_one"] = check_world_one(torch, opts, tmp)

        batch, draws = dp_inputs(torch, opts, DP_WORLD, 23)
        model, optimizer, step = dp_flagship_step(torch, opts, "cuda")
        dp_inject(model, draws)
        on_card = {k: v.to("cuda") for k, v in batch.items()}
        with TopkRecorder() as rec:
            want = step(on_card)
        want_params = dp_params(model)
        alone_ms = dp_timed_steps(torch, step, on_card, sum(DP_TIMED))[DP_TIMED[0]:]
        n_params = want_params.numel()
        del model, optimizer, step, on_card
        gc.collect()
        torch.cuda.empty_cache()
        torch.save({"batch": batch, "draws": draws, "topk": [i[2] for i in rec.indices]},
                   os.path.join(tmp, "inputs.pt"))
        alone_eval = eval_cli.main(["--coco-path", opts["coco"], "--batch-size",
                                    str(EVAL_BATCH), "--device", "cuda", "--model-config",
                                    dp_config_path(opts), "--result-json",
                                    os.path.join(tmp, "alone.json")])
        gc.collect()
        torch.cuda.empty_cache()

        t0 = time.perf_counter()
        torch.multiprocessing.spawn(dp_process, args=(opts, tmp), nprocs=DP_WORLD, join=True)
        spawn_s = time.perf_counter() - t0
        ranks = [torch.load(os.path.join(tmp, f"rank{r}.pt"), weights_only=False)
                 for r in range(DP_WORLD)]
        phase(13, f"(c) {DP_WORLD} processes ({opts['backend']}, {opts['cards']}: "
                  f"{', '.join(r['device'] + ' ' + r['name'] for r in ranks)}) ran in "
                  f"{spawn_s:.1f} s")
        for r, out in enumerate(ranks):
            if out["backend"] != opts["backend"]:
                raise AssertionError(f"rank {r} ran {out['backend']}, not {opts['backend']}")
            loss_err = dp_losses_err(out["metrics"], want)
            norm_err = abs(out["metrics"]["grad_norm"] - want["grad_norm"]) / want["grad_norm"]
            if loss_err > TOL_DP_LOSS or norm_err > TOL_DP_NORM:
                raise AssertionError(f"rank {r}: the 2-process step's losses are {loss_err:.3e} "
                                     f"rel and grad_norm {norm_err:.3e} rel from the one-process "
                                     "B=2 step's")
            if not torch.equal(out["digest"], ranks[0]["digest"]):
                raise AssertionError(f"rank {r}'s parameters differ from rank 0's")
            result.setdefault("loss_rel", []).append(loss_err)
            result.setdefault("grad_norm_rel", []).append(norm_err)
        top, share = dp_param_diff(ranks[0]["params"], want_params, lr)
        if share > TOL_DP_SHARE:
            raise AssertionError(f"the 2-process step's parameters: {share:.3e} of elements "
                                 "apart from the one-process B=2 step's by more than lr/1000")
        per_step = {"msda_fwd": 18, "msda_bwd": 18, "relation_bias_v4_fwd": 5}
        if any(out["launches"] != {k: n * out["steps"] for k, n in per_step.items()}
               for out in ranks):
            raise AssertionError(f"launches per process {[o['launches'] for o in ranks]}, "
                                 "expected 18 msda_fwd, 18 msda_bwd, 5 relation_bias_v4_fwd "
                                 "a step")
        phase(13, f"(c) flagship step, B=1 a process against one process at B=2 (same images, "
                  f"denoising draws and top-k): total {ranks[0]['metrics']['total_loss']:.6f} vs "
                  f"{want['total_loss']:.6f}; loss terms within "
                  f"{max(result['loss_rel']):.3e} rel (tolerance {TOL_DP_LOSS:g}), grad_norm "
                  f"{ranks[0]['metrics']['grad_norm']:.6f} vs {want['grad_norm']:.6f} "
                  f"({max(result['grad_norm_rel']):.3e} rel, tolerance {TOL_DP_NORM:g}); "
                  f"parameters after the update max |diff| {top:.3e}, {share:.3e} of "
                  f"{n_params} elements apart by more than lr/1000 (tolerance "
                  f"{TOL_DP_SHARE:g}); both processes' parameters equal; launches per step "
                  f"and process: {per_step}")
        step_p50 = statistics.median(ranks[0]["step_ms"])
        reduce_p50 = statistics.median(ranks[0]["reduce_ms"])
        alone_p50 = statistics.median(alone_ms)
        mbytes = 4 * n_params / 1e6
        phase(13, f"(c) step p50: {DP_WORLD} processes at B=1 {step_p50:.3f} ms "
                  f"({', '.join(f'{t:.3f}' for t in ranks[0]['step_ms'])}; rank 1 "
                  f"{statistics.median(ranks[1]['step_ms']):.3f}), one process at B=2 "
                  f"{alone_p50:.3f} ms ({', '.join(f'{t:.3f}' for t in alone_ms)}); gradient "
                  f"all-reduce p50 {reduce_p50:.3f} ms a step "
                  f"({', '.join(f'{t:.3f}' for t in ranks[0]['reduce_ms'])}) over "
                  f"{mbytes:.1f} MB ({n_params} trainable parameters x 4 B, "
                  f"{mbytes / reduce_p50:.3f} GB/s); peak memory a process "
                  f"{max(o['peak_gib'] for o in ranks):.3f} GiB")
        result.update(loss_rel_max=max(result["loss_rel"]),
                      grad_norm_rel_max=max(result["grad_norm_rel"]), params_max_abs=top,
                      params_share=share, step_ms_p50=step_p50, step_ms=ranks[0]["step_ms"],
                      alone_b2_ms_p50=alone_p50, alone_b2_ms=alone_ms, reduce_ms_p50=reduce_p50,
                      reduce_ms=ranks[0]["reduce_ms"], reduce_mb=mbytes,
                      trainable_params=n_params, launches_per_step=per_step,
                      peak_gib=max(o["peak_gib"] for o in ranks))

        cli = [o["train_cli"] for o in ranks]
        resume = [o["resume"] for o in ranks]
        if cli[0]["checkpoints"] != ["0.pt"] or cli[0]["weights"] != ["best_ap.npz",
                                                                     "best_ap50.npz",
                                                                     "latest.npz"]:
            raise AssertionError(f"train CLI wrote {cli[0]['checkpoints']}, {cli[0]['weights']}")
        if cli[0]["evals"] != cli[1]["evals"] or len(cli[0]["evals"]) != 1:
            raise AssertionError(f"train CLI evaluations differ across processes: "
                                 f"{[c['evals'] for c in cli]}")
        if [c["steps"] for c in cli] != [TRAIN_IMAGES // DP_WORLD] * DP_WORLD or \
                cli[0]["total_loss"] != cli[1]["total_loss"]:
            raise AssertionError(f"train CLI: {[c['steps'] for c in cli]} steps, last losses "
                                 f"{[c['total_loss'] for c in cli]}")
        if [r["steps"] for r in resume] != [2, 2] or resume[0]["epochs"] != [1] or \
                resume[0]["checkpoints"] != ["1.pt"]:
            raise AssertionError(f"train CLI --resume: {resume}")
        stats = cli[0]["evals"][0]["stats"]
        phase(13, f"(c) train CLI, {DP_WORLD} processes at B=1 over the {TRAIN_IMAGES}-image "
                  f"split: {cli[0]['steps']} steps each in {cli[0]['seconds']:.1f} s (step p50 "
                  f"{statistics.median(cli[0]['step_ms'][1:]):.3f} ms), rank 0 wrote "
                  f"{cli[0]['checkpoints']} and {cli[0]['weights']}; the in-training "
                  f"evaluation's AP {stats['AP']:.4f} / AP50 {stats['AP50']:.4f} the same in "
                  f"both; --resume into epoch 1: {resume[0]['steps']} steps in "
                  f"{resume[0]['seconds']:.1f} s, wrote {resume[0]['checkpoints']}")
        evals = [o["eval_cli"] for o in ranks]
        for e in evals:
            if e["stats"] != alone_eval["stats"]:
                raise AssertionError(f"eval CLI on {DP_WORLD} processes: stats {e['stats']} "
                                     f"differ from one process's {alone_eval['stats']}")
        predictions = []
        for name in ("eval.json", "alone.json"):
            with open(os.path.join(tmp, name)) as f:
                predictions.append(sorted(json.load(f), key=lambda p: (
                    p["image_id"], p["category_id"], -p["score"], p["bbox"])))
        if predictions[0] != predictions[1]:
            raise AssertionError(f"eval CLI: rank 0's result JSON ({len(predictions[0])} "
                                 f"predictions) differs from one process's "
                                 f"({len(predictions[1])})")
        phase(13, f"(c) eval CLI, {DP_WORLD} processes at B={EVAL_BATCH} over the split "
                  f"({[e['images'] for e in evals]} images): each process's 12 stats equal "
                  f"one process's ({', '.join(f'{k} {alone_eval['stats'][k]:.4f}' for k in STATS[:3])}"
                  f", ...; seeded weights), and rank 0's result JSON holds one process's "
                  f"{len(predictions[1])} predictions exactly; {evals[0]['seconds']:.2f} s "
                  f"against one process's {alone_eval['seconds']:.2f} s")
        result.update(train_cli={k: cli[0][k] for k in ("steps", "seconds", "checkpoints",
                                                         "weights")},
                      train_cli_step_ms_p50=statistics.median(cli[0]["step_ms"][1:]),
                      resume={k: resume[0][k] for k in ("steps", "seconds", "checkpoints")},
                      eval_cli_seconds=[e["seconds"] for e in evals],
                      alone_eval_seconds=alone_eval["seconds"], spawn_s=spawn_s)
    for key, row in (("msda_fwd", "msda"), ("msda_bwd", "msda_bwd"),
                     ("relation_bias_v4_fwd", "relation")):
        kernels[row]["dp_launches"] = [o["launches"][key] for o in ranks]
    result["seconds"] = time.perf_counter() - t_phase
    phase(13, f"done in {result['seconds']:.1f} s")
    return result

# phase 14, the rest of the host data path: cv2's outputs and PNG decodes
# from tests/data/torch_port/make_fixtures.py, every registered train preset
# through the loader, and the train CLI at full width under three presets
DATA_PATH_BATCH = 2
DATA_PATH_STEPS = 8  # one epoch of the 16-image train split at B=2
DATA_PATH_SKIP = 2  # steps left out of the numbers (model and loader warm-up)
PNG_FIXTURES = ("gray", "rgb", "rgba", "rgb16", "gray16", "palette", "palette4", "gray1",
                "gray_alpha", "filters") + tuple(
    f"adam7_c{color}_{depth}" for color, depths in (
        (0, (1, 2, 4, 8, 16)), (2, (8, 16)), (3, (1, 2, 4, 8)), (4, (8, 16)), (6, (8, 16)))
    for depth in depths) + ("adam7_tiny", "exif3", "exif6", "exif8")
# (label, train config's transforms, annotation file, return_masks, canvas)
DATA_PATH_RUNS = (
    ("strong_album", "transforms.strong_album(normalize_host=False)",
     "instances_train2017.json", False, "800,1344"),
    ("mosaic_detr + SimpleCopyPaste (masks)",
     "transforms.Compose(transforms.mosaic_detr(normalize_host=False), "
     "mix_transforms.SimpleCopyPaste(p=0.5))", "instances_train2017_segm.json", True,
     "800,1344"),
    ("lsj", "transforms.lsj(normalize_host=False)", "instances_train2017.json", False,
     "1024,1024"),
)
DATA_PATH_CONFIG = """import os

from relation_detr_tpu_torch.configs.train_config import *  # noqa: F401,F403
from relation_detr_tpu_torch.data import mix_transforms, transforms
from relation_detr_tpu_torch.data.coco import CocoDetection


def train_dataset(root=coco_path, device="cuda", decode=None):
    return CocoDetection(
        img_folder=os.path.join(root, "train2017"),
        ann_file=os.path.join(root, "annotations", {ann!r}),
        transforms={transforms},
        train=True,
        return_masks={masks},
        device=device,
        decode=decode,
    )
"""


def check_cv_golden(np):
    """Phase 14 (a): ``data/cv_ops.py`` and the PNG decode on this machine's
    numpy against cv2's outputs committed in ``cv_ops_golden.npz`` and
    ``png/*.npy``: equal bytes (the Gaussian blur of float noise within two
    float32 ulps); a broken JPEG raises ``UnreadableImage`` through nvJPEG.
    Returns the checks' names and the seconds they took."""
    from relation_detr_tpu_torch.data import cv_ops, image_io

    t0 = time.perf_counter()
    folder = os.path.join(ROOT, EVAL_DATA)
    g = dict(np.load(os.path.join(folder, "cv_ops_golden.npz")))
    verts = np.split(g["poly_vertices"], np.cumsum(g["poly_lengths"])[:-1])
    ends = np.cumsum(np.concatenate([[0], g["poly_counts"]]))
    checks = {
        "rgb2hsv": (cv_ops.rgb2hsv(g["image"]), g["rgb2hsv"]),
        "hsv2rgb": (cv_ops.hsv2rgb(g["hsv_in"]), g["hsv2rgb"]),
        "rgb2gray": (cv_ops.rgb2gray(g["image"]), g["rgb2gray"]),
        "blur3": (cv_ops.blur3(g["image"]), g["blur3"]),
        "median3": (cv_ops.median3(g["image"]), g["median3"]),
        "gaussian_blur5 (0/1 alpha)": (cv_ops.gaussian_blur5(g["alpha"]), g["gaussian_alpha"]),
        "shift": (np.stack([cv_ops.shift(g["image"], dx, dy) for dx, dy in g["shifts"]]),
                  g["shift_image"]),
        "shift (mask)": (np.stack([cv_ops.shift(g["mask"], dx, dy) for dx, dy in g["shifts"]]),
                         g["shift_mask"]),
        "fill_poly": (np.stack([cv_ops.fill_poly(np.zeros((96, 128), np.uint8), verts[a:b], 1)
                                for a, b in zip(ends[:-1], ends[1:])]),
                      np.unpackbits(g["fill_poly"]).reshape(-1, 96, 128)),
    }
    for h, w in g["nearest_sizes"]:
        checks[f"resize_nearest {h}x{w}"] = (cv_ops.resize_nearest(g["image"], int(h), int(w)),
                                             g[f"nearest_{h}x{w}"])
    for q in g["jpeg_qualities"]:
        checks[f"jpeg_roundtrip q{q}"] = (cv_ops.jpeg_roundtrip(g["image"], int(q)),
                                          g[f"jpeg_{q}"])
    for name in PNG_FIXTURES:
        path = os.path.join(folder, "png", name + ".png")
        checks[f"png {name}"] = (image_io.read_image(path),
                                 np.load(os.path.join(folder, "png", name + ".npy")))
    bad = [k for k, (got, want) in checks.items()
           if got.shape != want.shape or got.dtype != want.dtype or not np.array_equal(got, want)]
    noise = cv_ops.gaussian_blur5(g["noise"])
    ulps = float((np.abs(noise - g["gaussian_noise"])
                  / np.spacing(np.abs(g["gaussian_noise"]))).max())
    if ulps > 2:
        bad.append(f"gaussian_blur5 (float noise) {ulps} ulps")
    if bad:
        raise AssertionError(f"phase 14 (a): differ from cv2's outputs: {bad}")
    try:
        image_io.decode_image(np.frombuffer(b"\xff\xd8\xff\xe0" + bytes(40), np.uint8),
                              "broken.jpg")
    except image_io.UnreadableImage:
        pass
    else:
        raise AssertionError("phase 14 (a): a broken JPEG decoded")
    seconds = time.perf_counter() - t0
    phase(14, f"(a) cv_ops and the PNG decode on numpy {np.__version__} equal cv2's outputs: "
              f"{len(checks)} checks ({len(g['poly_counts'])} polygons, JPEG q "
              f"{[int(q) for q in g['jpeg_qualities']]}, {len(PNG_FIXTURES)} PNG files), "
              f"gaussian_blur5 on float noise within {ulps:.1f} ulps; a broken JPEG raises "
              f"UnreadableImage through nvJPEG ({seconds:.2f} s)")
    return dict(checks=sorted(checks), gaussian_noise_ulps=ulps, seconds=seconds)


def run_preset_loaders(torch):
    """Phase 14 (b): every registered train preset through the port's
    ``DataLoader`` (4 reader threads, nvJPEG decode, the canvas buckets)
    over the committed train split, one epoch of B=2, after one decode
    that sets nvJPEG up: the wall time per image (collate's shrink of an
    image larger than the largest bucket included, in the loader's one
    batching thread) and the decode and transform time per image (summed
    over the threads); every batch uint8, its boxes' centres in [0, 1] and sizes in
    (0, 1]."""
    import numpy as np

    from relation_detr_tpu_torch.data import image_io, transforms
    from relation_detr_tpu_torch.data import loader as port_loader
    from relation_detr_tpu_torch.data.coco import CocoDetection

    split = os.path.join(ROOT, EVAL_DATA, "synth_coco")
    rows = {}
    image_io.read_image(os.path.join(split, "train2017", "000000000000.jpg"))  # nvJPEG's set-up
    for name, make in transforms.PRESETS.items():
        dataset = CocoDetection(os.path.join(split, "train2017"),
                                os.path.join(split, "annotations", "instances_train2017.json"),
                                make(normalize_host=False), train=True, device="cuda")
        loader = port_loader.DataLoader(dataset, batch_size=DATA_PATH_BATCH, shuffle=True,
                                        seed=0, num_workers=4, drop_last=True)
        t0 = time.perf_counter()
        batches = list(loader)
        wall = time.perf_counter() - t0
        images = DATA_PATH_BATCH * len(batches)
        for b in batches:
            boxes = b["gt_boxes"][b["gt_valid"]]
            if b["images"].dtype != np.uint8 or not (boxes[:, 2:] > 0).all() or \
                    not (boxes[:, :2] >= 0).all() or not (boxes <= 1).all():
                raise AssertionError(f"phase 14 (b) {name}: a batch out of range")
        rows[name] = dict(images=images, wall_ms_per_image=1e3 * wall / images,
                          decode_ms_per_image=1e3 * dataset.seconds["decode"] / images,
                          transform_ms_per_image=1e3 * dataset.seconds["transform"] / images,
                          canvases=sorted({tuple(b["images"].shape[1:3]) for b in batches}),
                          boxes_per_image=float(sum(b["gt_valid"].sum() for b in batches)
                                                / images))
        phase(14, f"(b) {name}: {images} images through the loader (4 threads, nvJPEG) in "
                  f"{1e3 * wall / images:.3f} ms an image wall; decode "
                  f"{rows[name]['decode_ms_per_image']:.3f}, transform "
                  f"{rows[name]['transform_ms_per_image']:.3f} ms an image (summed over the "
                  f"threads); canvases {rows[name]['canvases']}, "
                  f"{rows[name]['boxes_per_image']:.2f} boxes an image")
    return rows


def run_data_path_cli(torch, tmp, label, preset, ann, masks, canvas):
    """Phase 14 (c): the train CLI on the flagship at full width, B=2, one
    epoch of the committed split (DATA_PATH_STEPS steps, no evaluation)
    under a train config whose dataset takes ``preset``: 18 msda_fwd, 18
    msda_bwd and 5 relation_bias_v4_fwd launches a step, one ycc_to_rgb
    at least an image of the split (a mosaic reads four, a copy-paste one
    more); every loss finite. Returns the step p50 and range, the main
    thread's wait for the next batch, the peak memory and the launches."""
    from relation_detr_tpu_torch import train

    config = os.path.join(tmp, f"train_config_{len(os.listdir(tmp))}.py")
    with open(config, "w") as f:
        f.write(DATA_PATH_CONFIG.format(ann=ann, transforms=preset, masks=masks))
    out = os.path.join(tmp, os.path.basename(config)[:-3])
    args = ["--config-file", config, "--coco-path", os.path.join(ROOT, EVAL_DATA, "synth_coco"),
            "--output-dir", out, "--num-epochs", "1", "--max-steps", str(DATA_PATH_STEPS),
            "--batch-size", str(DATA_PATH_BATCH), "--canvas", canvas, "--seed", "0",
            "--device", "cuda"]
    counters = train_cli_counters()
    for fn in counters.values():
        fn.launches = 0
    torch.cuda.reset_peak_memory_stats()
    got = train.main(args)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() / 2**30
    launches = {k: fn.launches for k, fn in counters.items()}
    steps = len(got["steps"])
    per_image = 4 if "mosaic" in preset else 1
    if steps != DATA_PATH_STEPS or launches["msda_fwd"] != 18 * steps or \
            launches["msda_bwd"] != 18 * steps or launches["relation_bias_v4_fwd"] != 5 * steps \
            or launches["ycc_to_rgb"] < per_image * DATA_PATH_BATCH * steps:
        raise AssertionError(f"phase 14 (c) {label}: {steps} steps, launches {launches}")
    losses = [s["total_loss"] for s in got["steps"]]
    if not all(math.isfinite(v) for v in losses) or got["metrics"]["nonfinite_count"]:
        raise AssertionError(f"phase 14 (c) {label}: non-finite losses {losses}")
    timed_steps = got["steps"][DATA_PATH_SKIP:]
    times = [s["step"] for s in timed_steps]
    waits = [s["wait"] for s in timed_steps]
    row = dict(canvas=canvas, steps=steps, step_ms_p50=statistics.median(times),
               step_ms_range=[min(times), max(times)], wait_ms_p50=statistics.median(waits),
               wait_ms_max=max(waits), wait_ms_all=[s["wait"] for s in got["steps"]],
               peak_gib=peak, launches=launches, losses=losses)
    phase(14, f"(c) train CLI, flagship B={DATA_PATH_BATCH} {canvas.replace(',', 'x')} fp32, "
              f"{label}: {steps} steps, steps {DATA_PATH_SKIP}-{steps - 1}: step p50 "
              f"{row['step_ms_p50']:.3f} ms (range {min(times):.3f}-{max(times):.3f}); the "
              f"main thread's wait for the next batch p50 {row['wait_ms_p50']:.3f} ms (max "
              f"{row['wait_ms_max']:.3f}; every step's {[round(w, 1) for w in row['wait_ms_all']]}"
              f"); peak memory {peak:.3f} GiB; launches {launches}; losses finite")
    return row


def run_data_path(torch, kernels):
    """Phase 14: (a) ``check_cv_golden``; (b) ``run_preset_loaders``; (c)
    ``run_data_path_cli`` under each of DATA_PATH_RUNS."""
    import tempfile

    import numpy as np

    smi = _run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"])
    result = dict(device=smi, golden=check_cv_golden(np), loaders=run_preset_loaders(torch))
    result["train_cli"] = {}
    with tempfile.TemporaryDirectory() as tmp:
        for label, preset, ann, masks, canvas in DATA_PATH_RUNS:
            row = run_data_path_cli(torch, tmp, label, preset, ann, masks, canvas)
            result["train_cli"][label] = row
            for key, name in (("msda_fwd", "msda"), ("msda_bwd", "msda_bwd"),
                              ("relation_bias_v4_fwd", "relation"), ("ycc_to_rgb", "ycc_to_rgb")):
                kernels[name].setdefault("data_path_launches", {})[label] = row["launches"][key]
    return result


# ---------------------------------------------------------------------------
# phase 15, the tools: torch.export through the ops, the model benchmark, the
# op route's host cost, --show-dir in both CLIs

TOOLS_P50_RUNS = 20  # detects a form (exported, eager) for each p50
TOOLS_TINY_CANVAS = (256, 320)
TOOLS_TINY_FORMS = (  # label: MSDA defaults, relation version, the counter it must move
    ("tiled", dict(impl="tiled"), 4, ("msda_tiled", "tiled_matmul_core")),
    ("tiled_xla+sep", dict(impl="tiled_xla", tiled_sep_kernel=True), 4,
     ("msda_tiled", "sep_contract_fused")),
    ("relation v1", {}, 1, ("relation_bias", "fused_relation_bias")),
)
HOST_US_CALLS = 300  # calls a turn for the op route's host cost
TOOLS_TILED_LEVEL0 = (189, 128, 23, 19)  # the flagship level 0's tiles, slots, patch h, w
TOL_DECODE_MEAN = 0.25  # phase 7's bar of nvJPEG's decode against libjpeg's (cv2's)


def tools_counters():
    from relation_detr_tpu_torch.ops import msda, msda_tiled, relation_bias

    return {"msda_fwd": msda.multi_scale_deformable_attention,
            "relation_bias_v4_fwd": relation_bias.relation_bias_v4,
            "relation_bias_rel_fwd": relation_bias.fused_relation_bias,
            "tiled_core_fwd": msda_tiled.tiled_matmul_core,
            "sep_contract_fwd": msda_tiled.sep_contract_fused}


def launches_of(fn):
    """The kernel launches of one call of ``fn``, by kernel (counters set to
    0 just before it)."""
    import torch

    counters = tools_counters()
    for c in counters.values():
        c.launches = 0
    fn()
    torch.cuda.synchronize()
    return {k: c.launches for k, c in counters.items() if c.launches}


def event_p50s(torch, fns, n):
    """p50 ms of each of ``fns`` over ``n`` calls, each between two CUDA
    events and synchronised, in turns (a, b, b, a: n / 2 calls a turn)."""
    times = {k: [] for k in fns}
    order = list(fns) + list(fns)[::-1]
    for key in order:
        for _ in range(n // 2):
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            fns[key]()
            end.record()
            end.synchronize()
            times[key].append(start.elapsed_time(end))
    return {k: [statistics.median(v), min(v), max(v)] for k, v in times.items()}


def run_export_flagship(torch, tmp):
    """Phase 15 (a): the flagship fp32 (seeded weights, B=1, 800x1344)
    through ``tools.export_model --verify``: export, save and load seconds,
    the verify differences, the exported call's launches (msda_fwd 12,
    relation_bias_v4_fwd 5, nothing else) and the exported and eager detect
    p50 over TOOLS_P50_RUNS CUDA-event runs each."""
    import numpy as np

    from relation_detr_tpu_torch.tools import export_model

    out = os.path.join(tmp, "flagship.pt2")
    got = export_model.main(["--output", out, "--verify", "--height", str(CANVAS[0]),
                             "--width", str(CANVAS[1])])
    program, serving, (images, mask, sizes) = got["program"], got["serving"], got["example"]
    exported = program.module()
    x = torch.from_numpy(np.random.RandomState(1).randn(*images.shape).astype(np.float32)).cuda()
    with torch.no_grad():
        launches = launches_of(lambda: exported(x, mask, sizes))
        eager_launches = launches_of(lambda: serving(x, mask, sizes))
        if launches != {"msda_fwd": 12, "relation_bias_v4_fwd": 5} or launches != eager_launches:
            raise AssertionError(f"phase 15 (a): the exported detect launched {launches}, the "
                                 f"eager one {eager_launches}")
        p50 = event_p50s(torch, {"exported": lambda: exported(x, mask, sizes),
                                 "eager": lambda: serving(x, mask, sizes)}, TOOLS_P50_RUNS)
    row = dict(export_s=got["export_s"], save_s=got["save_s"], load_s=got["load_s"],
               bytes=got["bytes"], verify=got["verify"], launches=launches, p50_ms=p50)
    phase(15, f"(a) flagship exported in {got['export_s']:.3f} s, saved in {got['save_s']:.3f} "
              f"s ({got['bytes']} bytes), loaded in {got['load_s']:.3f} s; verify through the "
              f"disk (rtol 1e-3, atol 1e-5, labels equal): max abs diffs {got['verify']}; the "
              f"exported detect launched {launches}; detect p50 (min-max) ms over "
              f"{TOOLS_P50_RUNS} CUDA-event runs: exported {p50['exported'][0]:.3f} "
              f"({p50['exported'][1]:.3f}-{p50['exported'][2]:.3f}), eager "
              f"{p50['eager'][0]:.3f} ({p50['eager'][1]:.3f}-{p50['eager'][2]:.3f})")
    del got, program, exported, serving
    return row


def run_export_tiny_forms(torch, tmp):
    """Phase 15 (b): the tiny config exported under impl="tiled", under
    "tiled_xla" with the separable kernel and under relation version 1,
    each verified through the disk; each exported call must launch its
    form's kernel."""
    import numpy as np

    from relation_detr_tpu_torch.ops import msda, relation_bias
    from relation_detr_tpu_torch.tools import export_model

    rows = {}
    tiny = os.path.join(ROOT, "relation_detr_tpu_torch", "configs", "relation_detr",
                        "relation_detr_resnet50_tiny_test.py")
    for label, settings, version, _ in TOOLS_TINY_FORMS:
        out = os.path.join(tmp, f"tiny_{label.replace(' ', '_')}.pt2")
        relation_bias.set_fused_relation(version=version)
        try:
            with msda.msda_defaults(**settings):
                got = export_model.main(["--model-config", tiny, "--output", out, "--verify",
                                         "--height", str(TOOLS_TINY_CANVAS[0]),
                                         "--width", str(TOOLS_TINY_CANVAS[1])])
        finally:
            relation_bias.set_fused_relation(version=4)
        images, mask, sizes = got["example"]
        exported = got["program"].module()
        x = torch.from_numpy(
            np.random.RandomState(2).randn(*images.shape).astype(np.float32)).cuda()
        with torch.no_grad():
            launches = launches_of(lambda: exported(x, mask, sizes))
        want = {"tiled": "tiled_core_fwd", "tiled_xla+sep": "sep_contract_fwd",
                "relation v1": "relation_bias_rel_fwd"}[label]
        if not launches.get(want):
            raise AssertionError(f"phase 15 (b) {label}: the exported detect launched {launches}")
        rows[label] = dict(export_s=got["export_s"], load_s=got["load_s"],
                           verify=got["verify"], launches=launches)
    phase(15, "(b) tiny config exported and verified through the disk at "
              f"{TOOLS_TINY_CANVAS}: " + "; ".join(
                  f"{k}: export {v['export_s']:.3f} s, max abs diffs {v['verify']}, launches "
                  f"{v['launches']}" for k, v in rows.items()))
    return rows


def run_benchmark_tool(torch):
    """Phase 15 (c): ``tools.benchmark_model`` on the flagship."""
    from relation_detr_tpu_torch.tools import benchmark_model

    got = benchmark_model.main([])
    phase(15, f"(c) benchmark_model (flagship fp32 B=1 800x1344): params {got['params']}, "
              f"flops {got['flops']} ({100 * got['op_share']:.3f}% in the kernels' ops: "
              f"{got['op_flops']}), p50 {got['p50_ms']:.3f} ms, p90 {got['p90_ms']:.3f} ms, "
              f"queued {got['queued_ms']:.3f} ms/iter ({got['images_per_s']:.3f} images/s)")
    return got


def host_us(torch, fns, calls):
    """Host microseconds a call of each of ``fns`` (host clock around
    ``calls`` calls, the queue drained before; the device keeps up), in
    turns a, b, b, a."""
    got = {k: [] for k in fns}
    for key in list(fns) + list(fns)[::-1]:
        fns[key]()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(calls):
            fns[key]()
        got[key].append((time.perf_counter() - t0) / calls * 1e6)
        torch.cuda.synchronize()
    return {k: sum(v) / len(v) for k, v in got.items()}


def run_op_route_cost(torch, kernels):
    """Phase 15 (d): host microseconds a call of each op (the dispatcher to
    its CUDA implementation), of the direct ctypes launch it wraps and of
    its wrapper: msda_fwd at the flagship decoder's shape (Q=900 over
    22,323 tokens), relation_bias_v4_fwd and relation_bias_rel_fwd at
    N=900, tiled_core_fwd and sep_contract_fwd at level 0's operands (189
    tiles of 128 slots, a 23x19 patch)."""
    from relation_detr_tpu_torch.ops import library, msda, msda_tiled, relation_bias
    from relation_detr_tpu_torch.models.relation import box_rel_encoding

    gen = torch.Generator(device="cuda").manual_seed(15)
    dev = gen.device
    total = sum(h * w for h, w in LEVELS)
    value = torch.randn(1, total, 8, 32, device=dev, generator=gen)
    locs = torch.rand(1, 900, 8, 4, 4, 2, device=dev, generator=gen)
    attn = torch.rand(1, 900, 8, 4, 4, device=dev, generator=gen)
    flat = library.flat_levels(LEVELS)
    boxes = torch.rand(1, 900, 4, device=dev, generator=gen) * 0.5 + 0.25
    kernel = torch.randn(64, 8, device=dev, generator=gen)
    bias = torch.randn(8, device=dev, generator=gen)
    rel = box_rel_encoding(boxes, boxes).contiguous()
    nt, slots, ph, pw = TOOLS_TILED_LEVEL0
    m = torch.randint(0, ph * pw, (1, nt, 8, 16, slots), device=dev, generator=gen,
                      dtype=torch.int32)
    w = torch.rand(m.shape, device=dev, generator=gen)
    patch = torch.randn(1, nt, ph * pw, 256, device=dev, generator=gen)
    oy = torch.rand(1, nt, 8, 4, ph, slots, device=dev, generator=gen)
    ox = torch.rand(1, nt, 8, 4, pw, slots, device=dev, generator=gen)
    settings = (16, 10000.0, 100.0)
    calls = {
        "msda_fwd": (msda._msda_fwd, library.OPS.msda_fwd.default,
                     (value, flat, locs, attn), msda.multi_scale_deformable_attention,
                     (value, LEVELS, locs, attn)),
        "relation_bias_v4_fwd": (relation_bias._relation_bias_v4_fwd,
                                 library.OPS.relation_bias_v4_fwd.default,
                                 (boxes, boxes, kernel, bias, *settings, 1e-5),
                                 relation_bias.relation_bias_v4, (boxes, boxes, kernel, bias)),
        "relation_bias_rel_fwd": (relation_bias._fused_relation_bias_fwd,
                                  library.OPS.relation_bias_rel_fwd.default,
                                  (rel, kernel, bias, *settings),
                                  relation_bias.fused_relation_bias, (rel, kernel, bias)),
        "tiled_core_fwd": (msda_tiled._tiled_core_fwd, library.OPS.tiled_core_fwd.default,
                           (m, w, patch, 8, 32), msda_tiled.tiled_matmul_core,
                           (m, w, patch, (8, 32))),
        "sep_contract_fwd": (msda_tiled._sep_contract_fwd, library.OPS.sep_contract_fwd.default,
                             (oy, ox, patch), msda_tiled.sep_contract_fused, (oy, ox, patch)),
    }
    rows = {}
    with torch.no_grad():
        for name, (direct, op, args, wrapper, wargs) in calls.items():
            rows[name] = host_us(torch, {"direct": lambda: direct(*args),
                                         "op": lambda: op(*args),
                                         "wrapper": lambda: wrapper(*wargs)}, HOST_US_CALLS)
    for name, key in (("msda_fwd", "msda"), ("relation_bias_v4_fwd", "relation"),
                      ("relation_bias_rel_fwd", "relation_rel"),
                      ("tiled_core_fwd", "tiled_core_fwd"),
                      ("sep_contract_fwd", "sep_contract_fwd")):
        kernels[key]["op_route_host_us"] = rows[name]
    phase(15, "(d) host us a call (host clock over "
              f"{HOST_US_CALLS} calls a turn, in turns): " + "; ".join(
                  f"{k}: direct ctypes {v['direct']:.1f}, op {v['op']:.1f} (+"
                  f"{v['op'] - v['direct']:.1f}), wrapper {v['wrapper']:.1f}"
                  for k, v in rows.items()))
    return rows


def run_show_dir_clis(torch, tmp):
    """Phase 15 (e): the eval CLI with ``--show-dir`` over the committed val
    split and the folder CLI with ``--show-dir`` on two of its images with a
    weight file that holds ``_classes_`` (flagship, seeded weights, every
    detection drawn); each written JPEG is the drawing's ``encode_jpeg``,
    and decodes on the card through ``decode_image`` to
    ``cv_ops.jpeg_roundtrip`` of the drawing (cv2's decode of the file):
    equal bytes, or within phase 7's bar of nvJPEG against libjpeg."""
    import numpy as np

    import shutil

    from relation_detr_tpu_torch import inference
    from relation_detr_tpu_torch import test as port_test
    from relation_detr_tpu_torch.data import cv_ops, image_io
    from relation_detr_tpu_torch.utils.class_names import encode_labels
    from relation_detr_tpu_torch.utils.weights import save_weights

    drawn = {}
    write = image_io.write_image

    def recording(path, img, quality=95):
        drawn[path] = img.copy()
        return write(path, img, quality)

    coco = os.path.join(ROOT, "tests", "data", "torch_port", "synth_coco")
    folder = os.path.join(tmp, "folder")
    os.makedirs(folder)
    val = sorted(os.listdir(os.path.join(coco, "val2017")))[:2]
    for name in val:
        shutil.copy(os.path.join(coco, "val2017", name), folder)
    names = tuple(f"class {i}" for i in range(91))
    checkpoint = os.path.join(tmp, "flagship.npz")
    save_weights(checkpoint, importlib.import_module(CONFIGS + FLAGSHIP).build_model("cpu"),
                 extra={"_classes_": encode_labels(names)})
    port_test.write_image = inference.write_image = recording
    try:
        t0 = time.perf_counter()
        run = port_test.main(["--coco-path", coco, "--batch-size", "2", "--show-dir",
                              os.path.join(tmp, "show_eval"), "--show-conf", "0"])
        eval_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        folder_run = inference.main(["--image-dir", folder, "--checkpoint", checkpoint,
                                     "--show-dir", os.path.join(tmp, "show_folder"),
                                     "--score-threshold", "0"])
        folder_s = time.perf_counter() - t0
    finally:
        port_test.write_image = inference.write_image = write
    written = sorted(run["shown"]) + sorted(folder_run["written"])
    if sorted(drawn) != written or len(run["shown"]) != run["images"] or len(
            folder_run["written"]) != len(val):
        raise AssertionError(f"phase 15 (e): wrote {written}, drew {sorted(drawn)}")
    diffs = []
    for path in written:
        data = np.fromfile(path, np.uint8)
        if data.tobytes() != image_io.encode_jpeg(drawn[path]):
            raise AssertionError(f"phase 15 (e): {path} is not the drawing's encode_jpeg")
        got = image_io.decode_image(data, path).astype(np.int64)
        want = cv_ops.jpeg_roundtrip(drawn[path], 95)[..., ::-1].astype(np.int64)
        d = np.abs(got - want)
        diffs.append((int((d != 0).sum()), float(d.mean()), int(d.max()), d.size))
    equal = sum(1 for n, _, _, _ in diffs if n == 0)
    worst_mean = max(m for _, m, _, _ in diffs)
    row = dict(eval_images=run["images"], eval_s=eval_s, folder_images=len(val),
               folder_s=folder_s, files=len(written), decoded_equal=equal,
               differing_values=sum(n for n, _, _, _ in diffs),
               values=sum(v for _, _, _, v in diffs), max_mean_abs=worst_mean,
               max_abs=max(m for _, _, m, _ in diffs),
               boxes_drawn=sum(len(d["scores"]) for d in folder_run["detections"].values()))
    phase(15, f"(e) eval CLI --show-dir over {run['images']} images in {eval_s:.3f} s, folder "
              f"CLI --show-dir over {len(val)} images ({row['boxes_drawn']} boxes, class names "
              f"from the weight file) in {folder_s:.3f} s; {len(written)} JPEGs, each the "
              f"drawing's encode_jpeg; decoded on the card by nvJPEG: {equal} of "
              f"{len(written)} equal to cv_ops.jpeg_roundtrip byte for byte, "
              f"{row['differing_values']} of {row['values']} values differ, mean |diff| at most "
              f"{worst_mean:.4f} levels a file, max {row['max_abs']}")
    if worst_mean > TOL_DECODE_MEAN:
        raise AssertionError(f"phase 15 (e): a written JPEG decodes {worst_mean} levels from "
                             f"libjpeg's on average (bar {TOL_DECODE_MEAN})")
    return row


def run_tools(torch, kernels):
    """Phase 15: (a) ``run_export_flagship``; (b) ``run_export_tiny_forms``;
    (c) ``run_benchmark_tool``; (d) ``run_op_route_cost``; (e)
    ``run_show_dir_clis``."""
    import tempfile

    t0 = time.perf_counter()
    smi = _run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"])
    result = {"device": smi}
    with tempfile.TemporaryDirectory() as tmp:
        result["export_flagship"] = run_export_flagship(torch, tmp)
        gc.collect()
        torch.cuda.empty_cache()
        result["export_tiny"] = run_export_tiny_forms(torch, tmp)
        result["benchmark_model"] = {k: v for k, v in run_benchmark_tool(torch).items()}
        gc.collect()
        torch.cuda.empty_cache()
        result["op_route_host_us"] = run_op_route_cost(torch, kernels)
        result["show_dir"] = run_show_dir_clis(torch, tmp)
    result["seconds"] = time.perf_counter() - t0
    phase(15, f"[{smi}] done in {result['seconds']:.1f} s")
    return result


# --- phase 16: the JAX package's tiled MSDA settings and the clamp gate ------

# the documented tilings the three tiled kernels take (tile tokens, halos,
# margin): the JAX package's tile-size sweep at auto halos and margin 1,
# margin 2, and halos from the fast profile's to none and 8
SETTINGS_GRID = tuple(((t, 8), "auto", 1) for t in (10, 12, 14, 16, 24)) + (
    ((12, 10), "auto", 1), ((12, 8), "auto", 2), ((12, 8), (4, 3, 2, 2), 1),
    ((12, 8), (0, 0, 0, 0), 1), ((12, 8), (8, 8, 8, 8), 1))
SETTINGS_CANVASES = (CANVAS, LARGE_CANVAS)
# flagship B=1 detects under each setting group: (label, settings, batch,
# tolerance class: "exact" at TOL_TILED_EVAL, "bf16" in bf16 units (held at
# TOL_BF16_UNITS), "measured": printed, not held)
SETTING_GROUPS = (
    ("fast halos + overflow 0", dict(impl="tiled", tiled_halos=(4, 3, 2, 2), tiled_overflow=0),
     1, "measured"),
    ("halos 2 + overflow 8", dict(impl="tiled", tiled_halos=(2, 2, 2, 2), tiled_overflow=8), 1,
     "measured"),
    ("tile (24, 8)", dict(impl="tiled", tiled_tile_tokens=(24, 8)), 1, "exact"),
    ("t_major", dict(impl="tiled_xla", tiled_layout="t_major"), 1, "exact"),
    ("slab xy", dict(impl="tiled_xla", tiled_slab_order="xy"), 1, "exact"),
    ("slab bm", dict(impl="tiled_xla", tiled_slab_order="bm"), 1, "exact"),
    ("patch gather", dict(impl="tiled_xla", tiled_patch_mode="gather"), 1, "exact"),
    ("B=2 batch unroll", dict(impl="tiled_xla", tiled_batch_unroll=True,
                              tiled_slab_order="auto"), 2, "exact"),
    ("bf16 slab + dot", dict(impl="tiled_xla", tiled_dtype="bf16", tiled_dot_bf16=True,
                             tiled_sep_kernel=True), 1, "bf16"),
    ("int8 slab", dict(impl="tiled_xla", tiled_int8_slab=True), 1, "measured"),
)
TOL_BF16_UNITS = 8.0  # the heads after a bf16 contraction per level and layer
SETTINGS_DETECTS = 10
SETTINGS_TRAIN_TILES = (16, 8)
CLAMP_CLI_IMAGES = 4  # (d): the split's first two batches


def grid_geometry(torch, gen, canvas, bs, tiles, halos, margin):
    """The tiled operands at one geometry: inputs in the tiled regime on
    ``canvas``'s levels, and per level the entries, the soft one-hot axes,
    the patch and a cotangent, as ``msda_tiled`` builds them."""
    from relation_detr_tpu_torch.ops import msda, msda_tiled

    levels = canvas_levels(canvas)
    value, locs, attn = tiled_inputs(torch, gen, bs, "cuda", levels)
    with torch.no_grad(), msda.msda_defaults(tiled_tile_tokens=tiles, tiled_halos=halos,
                                             tiled_margin=margin):
        consts, ops = msda_tiled.tiled_level_operands(value, levels, locs, attn)
    out = []
    for op in ops:
        x0i, y0i, fx, fy, at, bx, by = op["sample"]
        ph, pw, h, w = op["ph"], op["pw"], op["h"], op["w"]
        with torch.no_grad():
            m, wt = msda_tiled._tiled_entries(x0i, y0i, fx, fy, at, bx, by, ph, pw, h, w)
            oy = msda_tiled._axis_soft(y0i, fy, by, ph, h, at).contiguous()
            ox = msda_tiled._axis_soft(x0i, fx, bx, pw, w, None).contiguous()
        g = torch.randn(bs, consts["nt"], consts["T"], 256, generator=gen, device="cuda")
        out.append(dict(m=m, wt=wt, oy=oy, ox=ox, patch=op["patch"], g=g, ph=ph, pw=pw))
    return consts, out


def check_settings_kernels(torch, kernels):
    """(a) tiled_core_fwd, tiled_core_bwd and sep_contract_fwd at every
    geometry of SETTINGS_GRID on both canvases at B=1 and 2, on the operands
    msda_tiled builds, against their plain versions at every level (fwd and
    sep at TOL_TILED, bwd at TOL_BWD_REL of each max, two bwd launches
    bit-identical); level 0, the largest patch, timed in turns with the
    plain versions, with its bound (phase 3's rule)."""
    from relation_detr_tpu_torch.ops import msda_tiled

    gen = torch.Generator(device="cuda").manual_seed(16)
    dims = (8, 32)
    rows = {k: [] for k in ("tiled_core_fwd", "tiled_core_bwd", "sep_contract_fwd")}
    for canvas in SETTINGS_CANVASES:
        for bs in (1, 2):
            for tiles, halos, margin in SETTINGS_GRID:
                consts, ops = grid_geometry(torch, gen, canvas, bs, tiles, halos, margin)
                nt, t = consts["nt"], consts["T"]
                errs = {k: 0.0 for k in rows}
                for lvl, op in enumerate(ops):
                    m, wt, patch, g = op["m"], op["wt"], op["patch"], op["g"]
                    with torch.no_grad():
                        got = msda_tiled.tiled_matmul_core(m, wt, patch, dims)
                        want = msda_tiled.tiled_core_reference(m, wt, patch, dims)
                        errs["tiled_core_fwd"] = max(errs["tiled_core_fwd"],
                                                     (got - want).abs().max().item())
                        del got, want
                        got = msda_tiled.tiled_core_backward(m, wt, patch, g, dims)
                        again = msda_tiled.tiled_core_backward(m, wt, patch, g, dims)
                        if not all(torch.equal(a, b) for a, b in zip(got, again)):
                            raise AssertionError(f"tiled_core_bwd {canvas} B={bs} {tiles} "
                                                 f"{halos} {margin} level {lvl}: two launches "
                                                 "differ")
                        want = msda_tiled.tiled_core_backward_reference(m, wt, patch, g, dims)
                        errs["tiled_core_bwd"] = max(errs["tiled_core_bwd"], *(
                            max_rel(a, b) for a, b in zip(got, want)))
                        del got, again, want
                        got = msda_tiled.sep_contract_fused(op["oy"], op["ox"], patch)
                        want = msda_tiled.sep_contract_reference(op["oy"], op["ox"], patch)
                        errs["sep_contract_fwd"] = max(errs["sep_contract_fwd"],
                                                       (got - want).abs().max().item())
                        del got, want
                for name, tol in (("tiled_core_fwd", TOL_TILED), ("tiled_core_bwd", TOL_BWD_REL),
                                  ("sep_contract_fwd", TOL_TILED)):
                    if not (errs[name] <= tol):
                        raise AssertionError(f"{name} {canvas} B={bs} tiles {tiles} halos "
                                             f"{halos} margin {margin}: error {errs[name]}")
                op = ops[0]
                m, wt, patch, g, oy, ox = (op[k] for k in ("m", "wt", "patch", "g", "oy", "ox"))
                ph, pw = op["ph"], op["pw"]
                with torch.no_grad():
                    times = {
                        "tiled_core_fwd": in_turns(
                            lambda: msda_tiled.tiled_core_reference(m, wt, patch, dims),
                            lambda: msda_tiled.tiled_matmul_core(m, wt, patch, dims), 1, 3),
                        "tiled_core_bwd": in_turns(
                            lambda: msda_tiled.tiled_core_backward_reference(m, wt, patch, g,
                                                                             dims),
                            lambda: msda_tiled.tiled_core_backward(m, wt, patch, g, dims), 1, 3),
                        "sep_contract_fwd": in_turns(
                            lambda: msda_tiled.sep_contract_reference(oy, ox, patch),
                            lambda: msda_tiled.sep_contract_fused(oy, ox, patch), 1, 3),
                    }
                out_bytes = size(g)
                bounds = {
                    # per entry and channel one FMA
                    "tiled_core_fwd": bound(size(m, wt, patch) + out_bytes, 2 * m.numel() * 32),
                    # dw and dpatch out; per entry and channel the dw product
                    # and sum and the dpatch FMA
                    "tiled_core_bwd": bound(size(m, wt, patch, g) + size(wt, patch),
                                            4 * m.numel() * 32),
                    # the A build (P FMAs per element) and the contraction
                    "sep_contract_fwd": bound(size(oy, ox, patch) + out_bytes,
                                              2 * bs * nt * 8 * ph * pw * t * (4 + 32)),
                }
                label = (f"{canvas[0]}x{canvas[1]} B={bs} tiles {tiles} halos {halos} margin "
                         f"{margin}: level 0 M={ph * pw} ({ph}x{pw}) T={t} nt={nt}")
                for name in rows:
                    ms, plain_ms = times[name]
                    b_ms, b_by = bounds[name]
                    rows[name].append(dict(canvas=list(canvas), batch=bs, tiles=list(tiles),
                                           halos=halos if halos == "auto" else list(halos),
                                           margin=margin, level0_rows=ph * pw, level0_pw=pw,
                                           slots=t, max_err=errs[name], ms=ms,
                                           plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by))
                phase(16, f"(a) {label}: " + "; ".join(
                    f"{name} err {errs[name]:.2e}, {times[name][0]:.4f} ms (plain "
                    f"{times[name][1]:.4f}, bound {bounds[name][0]:.4f} {bounds[name][1]})"
                    for name in rows))
                del consts, ops, op, m, wt, patch, g, oy, ox
    for name, grid in rows.items():
        kernels[name]["settings_grid"] = grid
    return rows


def overflow_shares(levels, locs):
    """Of the bilinear corners of the encoder call ``locs`` (B, S, H, L, P,
    2) on the valid slots, at the settings' geometry: the share that leaves
    its tile's patch inside the level, and the share of those past the
    settings' overflow capacity per (tile, head, level) (all of them at
    capacity 0), by the op's own flags and ranks."""
    from relation_detr_tpu_torch.ops import msda_tiled

    _, _, halos_auto = msda_tiled.tiled_geometry(levels, locs.shape[4])
    k = msda_tiled.overflow_capacity(halos_auto)
    valid, per_level = msda_tiled.off_patch_entries(levels, locs)
    off = over = corners = 0
    for bad, rank, _ in per_level:
        bad = bad & valid
        off += int(bad.sum())
        over += int((bad & (rank >= k)).sum())
        corners += int(valid.sum()) * bad.shape[0] * bad.shape[2] * bad.shape[3]
    return off / corners, over / corners


def run_settings_detects(torch, model, kernels):
    """(b) the flagship detect under each of SETTING_GROUPS against the
    gather's on the same full-canvas requests: the pre-top-k class logits
    and boxes of every proposal, the encoder's corner shares off the patch
    and past the overflow capacity, the p50 of SETTINGS_DETECTS detects and
    the launches of one detect per kernel."""
    from relation_detr_tpu_torch.inference import detect
    from relation_detr_tpu_torch.models.attention import record_sampling
    from relation_detr_tpu_torch.ops import msda, msda_tiled, relation_bias

    counted = {"msda_fwd": msda.multi_scale_deformable_attention,
               "relation_bias_v4_fwd": relation_bias.relation_bias_v4,
               "tiled_core_fwd": msda_tiled.tiled_matmul_core,
               "sep_contract_fwd": msda_tiled.sep_contract_fused}
    was_training = model.training
    model.eval()
    gen = torch.Generator(device="cuda").manual_seed(16)
    h, w = REQUESTS[3]
    images = torch.randn(2, *CANVAS, 3, generator=gen, device="cuda")
    mask = torch.zeros(2, *CANVAS, dtype=torch.bool, device="cuda")
    sizes = [[h, w]] * 2
    dtypes = {"bf16": torch.bfloat16}
    base, found = {}, {}
    for label, settings, bs, tol in (("gather", {}, 1, None), ("gather B=2", {}, 2, None)) + \
            SETTING_GROUPS:
        settings = {k: dtypes.get(v, v) if k == "tiled_dtype" else v for k, v in settings.items()}
        with msda.msda_defaults(**settings):
            for fn in counted.values():
                fn.launches = 0
            with TopkRecorder() as rec, record_sampling() as records:
                detect(model, images[:bs], mask[:bs], sizes[:bs], 100)
            torch.cuda.synchronize()
            launches = {k: fn.launches for k, fn in counted.items() if fn.launches}
            encoder = [r for r in records if r[1].shape[1] == sum(a * b for a, b in r[3])]
            shares = overflow_shares(LEVELS, encoder[0][1]) if settings else (0.0, 0.0)
            clamp = float(msda_tiled.tiled_clamp_fraction(LEVELS, *encoder[0][1:3])) \
                if settings else 0.0
            del records, encoder
            times = []
            for _ in range(SETTINGS_DETECTS):
                start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
                start.record()
                detect(model, images[:bs], mask[:bs], sizes[:bs], 100)
                end.record()
                torch.cuda.synchronize()
                times.append(start.elapsed_time(end))
        proposals = rec.candidates[0]
        if not settings:
            base[bs] = proposals
            phase(16, f"(b) [{label}] p50 {statistics.median(times):.3f} ms; launches {launches}")
            continue
        pre = []
        for a, b in zip(proposals, base[bs]):
            finite = torch.isfinite(b)
            if not torch.equal(finite, torch.isfinite(a)):
                raise AssertionError(f"(b) [{label}]: other proposals are invalid")
            pre.append((a[finite] - b[finite]).abs().max().item())
        units = max((a - b)[torch.isfinite(b)].abs().max().item() /
                    (b[torch.isfinite(b)].abs().max().item() * BF16_EPS)
                    for a, b in zip(proposals, base[bs]))
        if tol == "exact" and not (max(pre) <= TOL_TILED_EVAL):
            FAILURES.append(f"(b) [{label}]: pre-top-k differs from the gather by {pre}")
        if tol == "bf16" and not (units <= TOL_BF16_UNITS):
            FAILURES.append(f"(b) [{label}]: pre-top-k {units:.2f} bf16 units from the gather")
        if not any(k in launches for k in ("tiled_core_fwd", "sep_contract_fwd")) and \
                settings.get("impl") == "tiled":
            raise AssertionError(f"(b) [{label}]: no tiled kernel launched")
        found[label] = dict(pre_topk_abs=pre, bf16_units=units, off_patch_share=shares[0],
                            over_capacity_share=shares[1], clamp_fraction_weighted=clamp,
                            p50_ms=statistics.median(times), launches=launches, batch=bs,
                            held=tol)
        phase(16, f"(b) [{label}] flagship B={bs} detect vs gather: pre-top-k class logits "
                  f"{pre[0]:.3e}, boxes {pre[1]:.3e} ({units:.2f} bf16 units of the max; held "
                  f"{tol}); corners off the patch {shares[0]:.3e}, past the overflow capacity "
                  f"{shares[1]:.3e}, attention-weighted clamp fraction {clamp:.3e}; p50 "
                  f"{statistics.median(times):.3f} ms over {SETTINGS_DETECTS}; launches {launches}")
    model.train(was_training)
    return found


def settings_train_step(torch, model, cfg, batch, settings, record=None, topk=None):
    """One flagship train forward + backward outside the step (the same
    denoising draws), its loss terms and gradients; ``record`` / ``topk``
    pin the kinks and the two-stage top-k to another run's."""
    from relation_detr_tpu_torch.losses.criterion import relation_detr_loss
    from relation_detr_tpu_torch.ops import msda

    b = batch
    with TopkRecorder() if topk is None else PinnedTopk(topk) as rec, \
            PinnedKinks(model, record, True) as pins, msda.msda_defaults(**settings):
        outputs = model(b["images"], b["mask"], b["gt_labels"], b["gt_boxes"], b["gt_valid"],
                        train=True, generator=torch.Generator(device="cuda").manual_seed(1))
        total, losses = relation_detr_loss(cfg.build_criterion(), outputs, b["gt_labels"],
                                           b["gt_boxes"], b["gt_valid"], cfg.hybrid_assign)
        total.backward()
    grads = {n: p.grad.detach().clone() for n, p in model.named_parameters()
             if p.grad is not None}
    model.zero_grad(set_to_none=True)
    return dict(losses={k: v.item() for k, v in losses.items()}, grads=grads, pins=pins,
                topk=getattr(rec, "indices", None))


def run_settings_train(torch, model, kernels):
    """(c) one flagship train forward + backward under impl="tiled" at tile
    SETTINGS_TRAIN_TILES (tiled_core_bwd's one-stage form at level 0)
    against the gather's, the kinks and top-k pinned to the gather run's:
    loss terms at TOL_TRAIN_LOSS, every gradient at TOL_TRAIN_GRAD of its
    leaf's max; launches of the tiled kernels."""
    from relation_detr_tpu_torch.ops import msda_tiled, patch_scatter

    cfg = importlib.import_module(CONFIGS + "relation_detr_resnet50_800_1333")
    was_training = model.training
    model.train()
    gen = torch.Generator(device="cuda").manual_seed(16)
    batch = synthetic_batch(torch, gen, 1, 100, CANVAS, "cuda")
    try:
        gather = settings_train_step(torch, model, cfg, batch, {})
        counters = (msda_tiled.tiled_matmul_core, msda_tiled.tiled_core_backward,
                    patch_scatter.window_accumulate)
        for fn in counters:
            fn.launches = 0
        tiled = settings_train_step(torch, model, cfg, batch,
                                    dict(impl="tiled", tiled_tile_tokens=SETTINGS_TRAIN_TILES),
                                    record=gather["pins"], topk=gather["topk"])
        torch.cuda.synchronize()
        launches = [fn.launches for fn in counters]
    finally:
        model.train(was_training)
    if launches != [24, 24, 24]:
        raise AssertionError(f"(c) tiled train step: tiled_core_fwd / tiled_core_bwd / "
                             f"window_accumulate launches {launches}, expected 24 each")
    loss_err = max(abs(tiled["losses"][k] - v) / max(abs(v), 1e-12)
                   for k, v in gather["losses"].items())
    ratios = {n: (tiled["grads"][n] - g).abs().max().item() / max(g.abs().max().item(), 1e-30)
              for n, g in gather["grads"].items()}
    name, err = max(ratios.items(), key=lambda kv: kv[1])
    flips = tiled["pins"].flips
    phase(16, f"(c) flagship train forward + backward B=1 under impl=tiled, tiles "
              f"{SETTINGS_TRAIN_TILES}, against the gather's (kinks and top-k pinned; "
              f"{flips['msda']} MSDA samples in another cell, {flips['relu']} ReLU inputs of "
              f"another sign): {len(gather['losses'])} loss terms within {loss_err:.3e} rel, "
              f"{len(ratios)} grads within {err:.3e} of each leaf's max ({name}); launches "
              f"tiled_core_fwd / tiled_core_bwd / window_accumulate {launches}")
    if loss_err > TOL_TRAIN_LOSS or err > TOL_TRAIN_GRAD:
        FAILURES.append(f"(c) tiled train step at tiles {SETTINGS_TRAIN_TILES}: loss terms "
                        f"{loss_err:.3e}, grad of {name} {err:.3e}")
    kernels["tiled_core_bwd"]["settings_train_launches"] = launches[1]
    return dict(loss_rel_err=loss_err, grad_rel_err=err, worst_leaf=name, launches=launches)


def run_clamp_cli(torch):
    """(d) the eval CLI over the committed split's first CLAMP_CLI_IMAGES
    images with the seeded flagship weights (seed 0, the CLI's own) as an
    .npz: --msda-impl tiled --clamp-check on (the per-layer
    fraction logged), then --msda-profile fast (the fast halos forced:
    the gate measures them, the threshold at 1 so that it logs)."""
    import tempfile

    from relation_detr_tpu_torch import test as eval_cli
    from relation_detr_tpu_torch.ops import msda, msda_tiled
    from relation_detr_tpu_torch.utils.weights import save_weights

    coco = os.path.join(ROOT, EVAL_DATA, "synth_coco")
    found = {}
    with tempfile.TemporaryDirectory() as tmp:
        weights = os.path.join(tmp, "flagship.npz")
        cfg = importlib.import_module(CONFIGS + "relation_detr_resnet50_800_1333")
        save_weights(weights, cfg.build_model(device="cuda", seed=0))
        base = ["--coco-path", coco, "--batch-size", str(EVAL_BATCH), "--device", "cuda",
                "--max-images", str(CLAMP_CLI_IMAGES), "--checkpoint", weights,
                "--msda-impl", "tiled"]
        for label, extra in (("--clamp-check on", ["--clamp-check", "on"]),
                             ("--msda-profile fast", ["--msda-profile", "fast",
                                                      "--clamp-threshold", "1"])):
            with msda.msda_defaults():
                msda_tiled.tiled_matmul_core.launches = 0
                got = eval_cli.main(base + extra)
                halos = msda._MSDA_DEFAULTS["tiled_halos"]
            clamp = got["clamp"]
            if not clamp or not clamp.get("fractions") or \
                    msda_tiled.tiled_matmul_core.launches == 0:
                raise AssertionError(f"(d) eval CLI {label}: no clamp fraction logged or no "
                                     "tiled_core_fwd launch")
            if not all(math.isfinite(v) for v in got["stats"].values()):
                raise AssertionError(f"(d) eval CLI {label}: non-finite stats")
            found[label] = dict(fractions=clamp["fractions"], profile=clamp["profile"],
                                halos=halos if halos == "auto" else list(halos),
                                AP=got["stats"]["AP"], images=got["images"],
                                tiled_core_fwd=msda_tiled.tiled_matmul_core.launches)
            phase(16, f"(d) eval CLI {' '.join(base[-2:] + extra)} over {got['images']} images: "
                      f"clamp fraction per layer {clamp['fractions']}, profile "
                      f"{clamp['profile']}, halos {halos}; AP {got['stats']['AP']:.4f}; "
                      f"{msda_tiled.tiled_matmul_core.launches} tiled_core_fwd launches")
    return found


def run_settings(torch, kernels, model):
    """Phase 16: (a) the kernels over the settings grid, (b) the flagship
    detect under each setting group, (c) a tiled train step at tile (16,
    8), (d) the eval CLI's clamp gate."""
    out = {"kernels": check_settings_kernels(torch, kernels)}
    gc.collect()
    torch.cuda.empty_cache()
    out["detects"] = run_settings_detects(torch, model, kernels)
    out["train"] = run_settings_train(torch, model, kernels)
    out["clamp_cli"] = run_clamp_cli(torch)
    return out


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)", file=sys.stderr)
        return 1
    if not os.path.isdir(os.path.join(ROOT, "relation_detr_tpu_torch", "csrc")):
        print(f"chip_smoke: {ROOT} is not a checkout of the repository", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    from relation_detr_tpu_torch import _build

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False

    smi = _run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"])
    print(smi.splitlines()[0], flush=True)
    nvcc_version = _run([_build.find_nvcc(), "--version"]).splitlines()[-1]
    phase(1, f"device {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}; "
             f"python {sys.version.split()[0]}, torch {torch.__version__}, "
             f"CUDA {torch.version.cuda}; nvcc {nvcc_version}")
    phase(1, f"JPEG decoders (informational): {jpeg_decoders()}")

    fresh = not (_build.library_path().is_file() and _build.jpeg_library_path().is_file())
    t0 = time.perf_counter()
    _build.build_all()
    _build.load_library()
    _build.load_jpeg_library()
    phase(2, f"{'built' if fresh else 'reused'} "
             f"{os.path.relpath(_build.library_path(), ROOT)} and "
             f"{os.path.relpath(_build.jpeg_library_path(), ROOT)} and loaded them in "
             f"{time.perf_counter() - t0:.2f} s")

    seconds = {}

    def timed(n, fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        seconds[n] = seconds.get(n, 0.0) + time.perf_counter() - t0
        return out

    kernels = timed(3, check_kernels, torch)
    timed(3, check_msda_large_canvas, torch, kernels)
    timed(3, check_msda_bf16_kernels, torch, kernels)
    timed(3, check_eval_shapes, torch, kernels)
    timed(3, check_ycc_kernel, torch, kernels)
    timed(3, check_backward_kernels, torch, kernels)
    timed(3, check_tiled_kernels, torch, kernels)
    for label, settings, version in TINY_VARIANTS:
        timed(4, check_tiny_model, torch, label, settings, version)
        timed(4, check_tiny_train, torch, label, settings, version)
    timed(4, check_tiny_bf16, torch)
    model, model16 = timed(5, run_flagship, torch, kernels)
    timed(6, run_flagship_train, torch, model, kernels)
    step16 = timed(6, run_flagship_train_bf16, torch, kernels)
    evaluation = timed(7, run_evaluation, torch, kernels)
    training = timed(8, run_train, torch, kernels)
    families = timed(9, run_families, torch, kernels)
    large = timed(11, run_large_backbones, torch, kernels)
    vit_dcn = timed(12, run_vit_dcn, torch, kernels, model)
    settings = timed(16, run_settings, torch, kernels, model)
    timed(10, run_profiles, torch)
    timed(10, report_bilinear_sample, vit_dcn["bilinear_sample"], kernels, torch)
    precision = timed(10, check_precision_profiles, torch, model, model16, step16)
    del model16, step16
    evaluation["forward_busy"] = timed(10, check_eval_forward_busy, torch, model)
    training["cli_step_busy"] = timed(10, check_train_cli_busy, torch)
    timed(10, check_relation_calls, torch, model, kernels)
    del model  # phase 13's processes need the card's memory
    gc.collect()
    torch.cuda.empty_cache()
    data_parallel = timed(13, run_data_parallel, torch, kernels)
    data_path = timed(14, run_data_path, torch, kernels)
    tools = timed(15, run_tools, torch, kernels)
    phase(10, "seconds per phase: " + ", ".join(f"{n}: {t:.1f}" for n, t in seconds.items()))

    if FAILURES:
        raise AssertionError("; ".join(FAILURES))
    leaked = [m for m in ("jax", "flax", "cv2", "PIL", "matplotlib", "relation_detr_tpu")
              if m in sys.modules]
    if leaked:
        raise AssertionError(f"the port's path imported {leaked}")
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err", "ms", "plain_ms",
            "bound_ms", "bound_by", "library_ms")
    for row in kernels.values():
        missing = [k for k in keys if k not in row]
        if missing or not row["launches"]:
            raise AssertionError(f"kernel row {row['name']}: missing {missing}, launches "
                                 f"{row.get('launches')}")
    print(json.dumps({"precision": precision}), flush=True)
    print(json.dumps({"evaluation": evaluation}), flush=True)
    print(json.dumps({"training": training}), flush=True)
    print(json.dumps({"families": families}), flush=True)
    print(json.dumps({"large_backbones": large}), flush=True)
    print(json.dumps({"vit_dcn": vit_dcn}), flush=True)
    print(json.dumps({"data_parallel": data_parallel}), flush=True)
    print(json.dumps({"data_path": data_path}), flush=True)
    print(json.dumps({"tools": tools}), flush=True)
    print(json.dumps({"settings": {k: v for k, v in settings.items() if k != "kernels"}}),
          flush=True)
    print(json.dumps({"kernels": list(kernels.values())}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
