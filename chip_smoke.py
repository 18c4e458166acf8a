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
     encoder shape (Q=S=22,323) and the decoder shapes Q=900, 1100 and
     1500, each on the encoder-like and the scattered location sets,
     relation_bias_v4_fwd (N=900 and 1100, with bounds) and the relation
     bias's backward (N=1100), window_accumulate at the four levels' window
     grids (bit-identical, one covering-window table build per level, at
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
     the wrapper the decoder calls;
  4. in-model parity: the tiny-test config on the GPU (kernels) and on the
     CPU (plain versions), same weights and inputs: the eval forward, then
     one train forward + backward with the same CDN draws, run on the CPU
     twice: as is, and sampling at the GPU's MSDA locations; under the
     gather, impl="tiled", impl="tiled_xla" with tiled_sep_kernel, and the
     gather under relation version 1 (the card's relation_bias_rel_fwd
     against its plain version on the CPU, which takes the v4 math's
     otherwise);
  5. the flagship config (ResNet-50, embed 256, 6+6 layers, 900 queries,
     91 classes, fp32, seeded random weights) answers 4 requests on the
     800x1344 canvas through ``inference.detect``, each going through 12
     MSDA and 5 relation-bias kernel launches; then the B=1 p50 latency (15
     detects) and peak device memory; then the same weights on the
     full-canvas request under impl="tiled", under "tiled_xla" +
     tiled_sep_kernel and under relation versions 1 and 2: pre-top-k heads
     against the default's, launches per forward, p50 and peak memory of
     each;
  6. the flagship train step (``parallel.train_step.make_train_step``: CDN,
     hybrid branch, matcher, criterion, backward, clip, AdamW) on synthetic
     batches in the loader's layout: B=1 at GT capacity 100 (2 warm-up + 15
     timed steps) and 16 (2 + 5), B=2 at 100 (3 steps), then B=1 at 100
     under impl="tiled" (1 + 8 steps, no covering-window table built);
     p50 step time, peak memory, kernel launches and host matching
     seconds per step;
  7. the COCO evaluation path on the committed synthetic val split
     (tests/data/torch_port/): (a) nvJPEG decodes the fixtures (4:4:4,
     4:2:0, grayscale, EXIF Orientation 6) against cv2's decodes, shapes
     exact and mean |difference| within TOL_DECODE_MEAN (max, mean and the
     share more than 8 levels off printed), and the split's 8 JPEGs at
     their annotated sizes; (b) ``relation_detr_tpu_torch.test`` on the
     flagship config (seeded weights, B=2) over the split, twice: every
     canvas one that phase 3 held msda_fwd on, 12 msda_fwd and 5
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
     memory and the host's load average, past its first 2 steps;
  9. torch.profiler, after every timed phase (so that no profiler session
     runs before a p50): the MSDA kernels' device time per launch at each
     phase-3 shape and set, relation_bias_v4_fwd's and
     relation_bias_rel_fwd's at N=900 and 1100, tiled_core_fwd's at the four
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
     --profile-steps) device-busy time against its span; then a JSON
     kernel table, one row per kernel (launches: from the run of the
     path that takes it, each counter set to 0 just before that run:
     msda_fwd, msda_bwd and relation_bias_v4_fwd from the default train
     step, tiled_core_fwd/bwd and window_accumulate from the tiled train
     step, sep_contract_fwd from the sep-kernel eval, relation_bias_rel_fwd
     from the version-1 and version-2 evals; ycc_to_rgb, and
     eval_cli_launches of msda_fwd and relation_bias_v4_fwd, from phase
     7 (b)'s second CLI run; train_cli_launches of msda_fwd, msda_bwd,
     relation_bias_v4_fwd and ycc_to_rgb from phase 8 (a)), after JSON
     lines of phase 7's and phase 8's results, then the last line
     {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.

Bounds: bytes are each input read once and each output written once;
operations count one per sin/cos and two per FMA, as each row's comment
says.

Imports neither jax, flax, cv2, PIL nor the JAX package. Exits non-zero,
printing no result, without a CUDA device or outside a checkout of the
repository.
"""
from __future__ import annotations

import copy
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
TILED_TRAIN_RUN = (1, 100, 1, 8)
DETECT_RUNS = 15  # timed default detects (the p50 of the eval path)
# phase 4's forms: msda_defaults settings and relation bias version (None:
# the default, 4)
TINY_VARIANTS = (("gather", {}, None), ("tiled", dict(impl="tiled"), None),
                 ("tiled_xla + tiled_sep_kernel", dict(impl="tiled_xla", tiled_sep_kernel=True),
                  None),
                 ("gather + relation v1", {}, 1))
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
DECODE_FIXTURES = ("decode_444", "decode_gray", "decode_420", "decode_exif6")
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
# phase 9 after every timed phase, so that no profiler session precedes a
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
            phase(9, f"{label}: torch.profiler saw no device time")
            continue
        phase(9, f"{label}: device time (torch.profiler key_averages()): " +
              "; ".join(f"{k} {v[0]:.4f} ms over {v[1]} launches" for k, v in found.items()))


def msda_inputs(torch, gen, num_queries, dev):
    """The scattered set, the worst case for locality and the correctness
    set: locations uniform over the image (point 0) or over the image and a
    margin past it (points 1-3), whatever the query; every 7th query
    with point 1 on the left and top borders, every 11th with point 2 on
    the right and bottom ones, every 5th with point 3 on pixel centres of
    random tokens plus whole-pixel offsets."""
    total = sum(h * w for h, w in LEVELS)
    h_, l_, p_, d_ = 8, len(LEVELS), 4, 32
    value = torch.randn(1, total, h_, d_, generator=gen, device=dev)
    locs = torch.rand(1, num_queries, h_, l_, p_, 2, generator=gen, device=dev) * 1.2 - 0.1
    locs[:, :, :, :, 0] = torch.rand(1, num_queries, h_, l_, 2, generator=gen, device=dev)
    locs[:, ::7, :, :, 1] = 0.0
    locs[:, ::11, :, :, 2] = 1.0
    on_pixel_centres(torch, gen, locs[:, ::5, :, :, 3], LEVELS)
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


def check_msda_kernels(torch, rows):
    """msda_fwd and msda_bwd against their plain versions at the encoder
    shape (Q = S) and the decoder shapes Q = 900 (eval), 1100 (train:
    200 CDN slots + 900) and 1500 (hybrid), each on the encoder-like and
    the scattered set, timed in turns with them. A row's ms is the encoder
    shape on the encoder-like set; shapes_ms lists [kernel, plain, bound]
    for every shape and set."""
    from relation_detr_tpu_torch.ops import msda

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    total = sum(h * w for h, w in LEVELS)
    found = {"fwd": {}, "bwd": {}}
    errs = {"fwd": [], "bwd": []}
    device = {}  # phase 9: kernel-only device time per shape and set
    for nq in (total, 900, 1100, 1500):
        for set_name, make in MSDA_SETS:
            value, locs, attn = make(torch, gen, nq, dev)
            label = f"Q={nq} {set_name}"
            shape = f"B=1 Q={nq} S={total} H=8 D=32 L=4 P=4, {set_name}"
            with torch.no_grad():
                got = msda.multi_scale_deformable_attention(value, LEVELS, locs, attn)
                want = msda.msda_reference(value, LEVELS, locs, attn)
                torch.cuda.synchronize()
                err = (got - want).abs().max().item()
                if not (err <= TOL_KERNEL):
                    raise AssertionError(f"msda_fwd {shape}: max abs err {err} > {TOL_KERNEL}")
                ms, plain_ms = in_turns(
                    lambda: msda.msda_reference(value, LEVELS, locs, attn),
                    lambda: msda.multi_scale_deformable_attention(value, LEVELS, locs, attn),
                    5, 20)
            # 4 corner FMAs and a weight FMA per (q, h, l, p, d)
            fb = bound(size(value, locs, attn, got), 10 * got.numel() * 16)
            errs["fwd"].append(err)
            found["fwd"][label] = [ms, plain_ms, fb[0], fb[1]]
            phase(3, f"msda_fwd {shape}: max_abs_err {err:.3e}, kernel {ms:.4f} ms, plain "
                     f"{plain_ms:.4f} ms, bound {fb[0]:.4f} ms ({fb[1]})")
            del got, want

            grad_out = torch.randn(1, nq, 256, generator=gen, device=dev)
            got = msda.msda_backward(value, LEVELS, locs, attn, grad_out)
            inputs = [t.detach().requires_grad_(True) for t in (value, locs, attn)]
            with torch.enable_grad():
                out = msda.msda_reference(inputs[0], LEVELS, inputs[1], inputs[2])

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
                plain, lambda: msda.msda_backward(value, LEVELS, locs, attn, grad_out), 3, 10)
            PROFILES.append((
                f"msda_fwd x20 + msda_bwd x10, {shape}",
                lambda args=(value, locs, attn, grad_out): msda_calls(torch, msda, *args),
                ("msda_fwd_kernel", "msda_bwd_kernel"), device, label))
            # per (q, h, l, p, d): 4 corner atomics, 4 x 2 location FMAs, 4
            # weight FMAs and the sample FMA
            bb = bound(size(value, locs, attn, grad_out, *got), 2 * 17 * grad_out.numel() * 16)
            errs["bwd"].append(err)
            found["bwd"][label] = [ms, plain_ms, bb[0], bb[1]]
            phase(3, f"msda_bwd {shape}: max rel err value {rel[0]:.3e}, locations "
                     f"{rel[1]:.3e}, weights {rel[2]:.3e} (max abs {err:.3e}); kernel {ms:.4f} "
                     f"ms, plain backward {plain_ms:.4f} ms, bound {bb[0]:.4f} ms ({bb[1]})")
            del out, inputs, want, got
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


def msda_calls(torch, msda, value, locs, attn, grad_out):
    """msda_fwd 20 times and msda_bwd 10 times on one input set (phase 9
    profiles them: each kernel's device time without the host's gaps)."""
    with torch.no_grad():
        for _ in range(20):
            msda.multi_scale_deformable_attention(value, LEVELS, locs, attn)
    for _ in range(10):
        msda.msda_backward(value, LEVELS, locs, attn, grad_out)


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
    device = {}  # phase 9: the kernel's device time per launch at N = 900 and 1100
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
    return rows


def relation_v4_bound(src, tgt, kernel, bias, out):
    """Bound of relation_bias_v4_fwd: the boxes, weights and bias in, the
    bias out; per pair 32 sines and cosines (one operation each) and 2 x 32
    FMAs per head (xy and wh halves). The per-box wh features (O(N)) are
    left out."""
    pairs = out.numel() // out.shape[1]
    return bound(size(src, tgt, kernel, bias, out), pairs * (32 + 2 * 2 * 32 * out.shape[1]))


def relation_calls(torch, src, tgt, kernel, bias):
    """relation_bias_v4 20 times (phase 9 profiles its kernel)."""
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
    """tiled_matmul_core 20 times (phase 9 profiles its kernel)."""
    from relation_detr_tpu_torch.ops import msda_tiled

    with torch.no_grad():
        for _ in range(20):
            msda_tiled.tiled_matmul_core(m, wt, patch, dims)


def relation_rel_calls(torch, rel, kernel, bias):
    """fused_relation_bias 20 times (phase 9 profiles its kernel)."""
    from relation_detr_tpu_torch.ops import relation_bias

    with torch.no_grad():
        for _ in range(20):
            relation_bias.fused_relation_bias(rel, kernel, bias)


def tiled_inputs(torch, gen, bs, dev):
    """Encoder inputs in the tiled forms' regime: every token samples near
    its own raster position, up to num_points = 4 texels off on each level
    (the reach of the radial offset initialisation, inside the auto halos
    of 5)."""
    total = sum(h * w for h, w in LEVELS)
    value = torch.randn(bs, total, 8, 32, generator=gen, device=dev)
    refs = torch.cat([torch.stack(torch.meshgrid((torch.arange(w, device=dev) + 0.5) / w,
                                                 (torch.arange(h, device=dev) + 0.5) / h,
                                                 indexing="xy"), -1).reshape(-1, 2)
                      for h, w in LEVELS])
    texel = torch.tensor([(w, h) for h, w in LEVELS], device=dev, dtype=torch.float32)
    offs = torch.rand(bs, total, 8, len(LEVELS), 4, 2, generator=gen, device=dev) * 8 - 4
    locs = (refs[None, :, None, None, None] + offs / texel[:, None]).contiguous()
    attn = torch.rand(bs, total, 8, len(LEVELS), 4, generator=gen, device=dev)
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
    fwd_device = {}  # phase 9: tiled_core_fwd's device time per (B, level)
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
                # phase 9: device time per launch, the operands kept on the host
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
    rel_device = {}  # phase 9: the kernel's device time per launch at N = 900 and 1100
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


class PinnedKinks:
    """Pins the train path's kinks to the side another run took. Without
    ``record`` it records, in call order, every MSDA call's sampling
    locations (``models.attention``) and which inputs of every ReLU in the
    backbone are positive. With the ``record`` of another run, each MSDA
    call samples at the recorded locations and each backbone ReLU passes
    the inputs the record's passed, while the gradient still flows to this
    run's own tensors; ``flips`` counts the MSDA samples whose bilinear cell
    (the floor of the pixel coordinate) and the ReLU inputs whose sign
    differed from the record's."""

    def __init__(self, model, record=None):
        import torch
        from relation_detr_tpu_torch.models import attention

        self.torch, self.attention, self.model = torch, attention, model
        self.msda, self.relu = attention.multi_scale_deformable_attention, torch.relu
        self.record = record
        self.locations, self.signs = [], []
        self.flips = {"msda": 0, "relu": 0}
        self.hooks = []

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
        self.hooks = [
            self.model.backbone.register_forward_pre_hook(
                lambda *_: setattr(torch, "relu", self._relu)),
            self.model.backbone.register_forward_hook(
                lambda *_: setattr(torch, "relu", self.relu)),
        ]
        return self

    def __exit__(self, *exc):
        self.attention.multi_scale_deformable_attention = self.msda
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


def check_tiny_train(torch, label, settings, version):
    from relation_detr_tpu_torch.losses.criterion import relation_detr_loss
    from relation_detr_tpu_torch.ops import msda

    cfg = importlib.import_module(CONFIGS + "relation_detr_resnet50_tiny_test")
    cpu_model = cfg.build_model(device="cpu", seed=1).train()
    gen = torch.Generator().manual_seed(4)
    # Offsets on every non-backbone weight, as the CPU parity tests do. At
    # the initialisation itself the zero-initialised sampling offsets and
    # box heads put MSDA samples exactly on pixel centres, on the jump of
    # the location gradient, for every token at once.
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

    def run(model, dev, record=None):
        b = {k: v.to(dev) for k, v in batch.items()}
        with TopkRecorder() as rec, PinnedKinks(model, record) as pins, \
                msda.msda_defaults(**settings), RelationVersion(version, cpu_model) as launched:
            outputs = model(b["images"], b["mask"], b["gt_labels"], b["gt_boxes"],
                            b["gt_valid"], train=True,
                            noise_draws={k: v.to(dev) for k, v in draws.items()})
        if dev == "cuda":
            launched.check(label)
        total, losses = relation_detr_loss(cfg.build_criterion(), outputs, b["gt_labels"],
                                           b["gt_boxes"], b["gt_valid"], cfg.hybrid_assign)
        total.backward()
        grads = {n: p.grad.cpu() for n, p in model.named_parameters() if p.grad is not None}
        model.zero_grad(set_to_none=True)
        return dict(topk=rec.indices, losses={k: v.item() for k, v in losses.items()},
                    total=total.item(), grads=grads, pins=pins)

    gpu = run(gpu_model, "cuda")
    cpu = run(cpu_model, "cpu")
    pinned = run(cpu_model, "cpu", record=gpu["pins"])
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
    if err > TOL_TRAIN_GRAD:
        raise AssertionError(f"tiny train step: grad of {name} differs GPU vs CPU by "
                             f"{err:.3e} of its max")
    bb_name, bb_err, bb_count = worst(ratios, backbone=True)
    phase(4, f"[{label}] tiny-test config train forward + backward (CDN + hybrid) GPU vs CPU, same "
             f"draws: total {gpu['total']:.6f} vs {cpu['total']:.6f}, {len(cpu['losses'])} "
             f"loss terms within {loss_err:.3e} rel; {count} grads outside the backbone within "
             f"{err:.3e} of each leaf's max ({name}); {bb_count} backbone grads within "
             f"{bb_err:.3e} ({bb_name}), held below; top-k selections equal (indices that "
             f"differ inside exact ties: {', '.join(flipped)})")
    loss_err, ratios = compare(pinned, "CPU pinned")
    name, err = max(ratios.items(), key=lambda kv: kv[1])
    if err > TOL_TRAIN_GRAD:
        raise AssertionError(f"tiny train step: grad of {name} differs GPU vs CPU with the "
                             f"kinks pinned by {err:.3e} of its max")
    _, bb_err, _ = worst(ratios, backbone=True)
    flips = pinned["pins"].flips
    phase(4, f"[{label}] the same with the CPU's kinks pinned to the GPU's side ({flips['msda']} MSDA "
             f"samples in another bilinear cell, {flips['relu']} backbone ReLU inputs of "
             f"another sign): total {pinned['total']:.6f}, loss terms within {loss_err:.3e} rel; "
             f"all {len(ratios)} grads within {err:.3e} of each leaf's max ({name}), backbone "
             f"within {bb_err:.3e}")


def train_steps(torch, step, batch, warmup, timed, counters, label):
    """Runs warm-up + timed steps; checks finite losses and each counter's
    launches per step; prints p50, peak memory and host matching time."""
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
        if bad or not math.isfinite(metrics["total_loss"]) or metrics["nonfinite_count"]:
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
    phase(6, f"flagship train step {label} ({BOXES_PER_IMAGE} boxes per image) 800x1344 "
             f"fp32: p50 {statistics.median(times):.3f} ms ({len(times)} steps: "
             f"{', '.join(f'{t:.3f}' for t in times)}); peak memory {peak / 2**30:.3f} GiB; "
             f"host matching {statistics.median(host):.4f} s/step; total_loss "
             f"{metrics['total_loss']:.4f}, grad_norm {metrics['grad_norm']:.4f}, "
             f"{len(losses)} loss terms finite")


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
    detect(model, images, mask, sizes, 100)  # warm-up
    times = []
    for _ in range(DETECT_RUNS):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        detect(model, images, mask, sizes, 100)
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
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
    return model


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
    if not device:  # a session now and then sees no device activity at all
        launches, device = five_calls()
    phase(9, f"5 relation-bias calls of the flagship decoder (N = 900): {launches} "
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
    phase(9, f"flagship eval forward B={EVAL_BATCH} on {canvas} (make_detections_fn): span on "
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
            fb = bound(size(value, locs, attn, got), 10 * got.numel() * 16)
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
    (shapes exact, mean |difference| within TOL_DECODE_MEAN), and the
    split's JPEGs at their annotated sizes. Returns {fixture: [max, mean,
    share more than 8 levels off]}."""
    import numpy as np

    from relation_detr_tpu_torch.data import image_io

    folder = os.path.join(ROOT, EVAL_DATA)
    found = {}
    tol = TOL_DECODE_MEAN
    for name in DECODE_FIXTURES:
        got = image_io.read_image(os.path.join(folder, name + ".jpg"))
        want = np.load(os.path.join(folder, name + ".npy"))
        if got.shape != want.shape or got.dtype != np.uint8:
            raise AssertionError(f"decode {name}: {got.shape} {got.dtype}, cv2 {want.shape}")
        diff = np.abs(got.astype(np.int16) - want.astype(np.int16))
        found[name] = [int(diff.max()), float(diff.mean()), float((diff > 8).mean())]
        phase(7, f"decode {name}.jpg {got.shape}: |nvJPEG - cv2| max {diff.max()}, mean "
                 f"{diff.mean():.4f} (tolerance {tol}), share > 8 levels off "
                 f"{(diff > 8).mean():.4f}")
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


def run_train_cli_checked(torch, args, epochs, label):
    """One train CLI run with every counter set to 0 just before it: the
    launches must be 18 msda_fwd, 18 msda_bwd and 5 relation_bias_v4_fwd a
    step, 12 msda_fwd and 5 relation_bias_v4_fwd an evaluated image (B=1),
    and one ycc_to_rgb an image read; every step's loss finite, no skipped
    step. Returns (the CLI's result, launches, peak GiB, load averages)."""
    from relation_detr_tpu_torch import train

    counters = train_cli_counters()
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
    want = {"msda_fwd": 18 * steps + 12 * evals, "msda_bwd": 18 * steps,
            "relation_bias_v4_fwd": 5 * steps + 5 * evals,
            "ycc_to_rgb": TRAIN_IMAGES * epochs + evals}
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


def check_restore(torch, out):
    """Phase 8 (b): the train CLI's ``restore_training`` into a fresh model
    (other weights), AdamW, train step and EMA: every tensor and count
    bit-identical to the last checkpoint's."""
    from relation_detr_tpu_torch.configs import train_config
    from relation_detr_tpu_torch.parallel.train_step import make_train_step
    from relation_detr_tpu_torch.train import restore_training
    from relation_detr_tpu_torch.utils.checkpoint import CheckpointManager
    from relation_detr_tpu_torch.utils.ema import ema_init
    from relation_detr_tpu_torch.utils.param_groups import build_optimizer

    cfg = importlib.import_module(CONFIGS + "relation_detr_resnet50_800_1333")
    model = cfg.build_model(device="cuda", seed=11).train()
    optimizer = build_optimizer(model, train_config.learning_rate,
                                accumulate_steps=TRAIN_ACCUMULATE)
    step = make_train_step(model, cfg.build_criterion(), optimizer, cfg.hybrid_assign)
    ema = ema_init(dict(model.named_parameters()))
    manager = CheckpointManager(os.path.join(out, "checkpoints"))
    restore_training(manager, model, optimizer, step, ema, "cuda")
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
    overfit = check_overfit_on_card(torch)
    return dict(device=smi, numbers=numbers, outputs=outputs, restored=restored,
                launches=launches, evals=[e["stats"]["AP50"] for e in got["evals"]],
                overfit=overfit)


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
        phase(9, "train CLI step: torch.profiler saw no device time (not measured)")
        return None
    prof = {k: v for k, v in prof.items() if k != "trace"}
    phase(9, f"train CLI step (flagship B={TRAIN_BATCH}, --profile-steps 3,4): span "
             f"{prof['span_ms']:.3f} ms (host clock, synchronised), device busy "
             f"{prof['device_busy_ms']:.3f} ms (torch.profiler), idle share "
             f"{prof['idle_share']:.4f}")
    return prof


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
    timed(3, check_eval_shapes, torch, kernels)
    timed(3, check_ycc_kernel, torch, kernels)
    timed(3, check_backward_kernels, torch, kernels)
    timed(3, check_tiled_kernels, torch, kernels)
    for label, settings, version in TINY_VARIANTS:
        timed(4, check_tiny_model, torch, label, settings, version)
        timed(4, check_tiny_train, torch, label, settings, version)
    model = timed(5, run_flagship, torch, kernels)
    timed(6, run_flagship_train, torch, model, kernels)
    evaluation = timed(7, run_evaluation, torch, kernels)
    training = timed(8, run_train, torch, kernels)
    timed(9, run_profiles, torch)
    evaluation["forward_busy"] = timed(9, check_eval_forward_busy, torch, model)
    training["cli_step_busy"] = timed(9, check_train_cli_busy, torch)
    timed(9, check_relation_calls, torch, model, kernels)
    phase(9, "seconds per phase: " + ", ".join(f"{n}: {t:.1f}" for n, t in seconds.items()))

    leaked = [m for m in ("jax", "flax", "cv2", "PIL", "relation_detr_tpu") if m in sys.modules]
    if leaked:
        raise AssertionError(f"the port's path imported {leaked}")
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err", "ms", "plain_ms",
            "bound_ms", "bound_by", "library_ms")
    for row in kernels.values():
        missing = [k for k in keys if k not in row]
        if missing or not row["launches"]:
            raise AssertionError(f"kernel row {row['name']}: missing {missing}, launches "
                                 f"{row.get('launches')}")
    print(json.dumps({"evaluation": evaluation}), flush=True)
    print(json.dumps({"training": training}), flush=True)
    print(json.dumps({"kernels": list(kernels.values())}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
