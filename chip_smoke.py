#!/usr/bin/env python3
"""Smoke run of the PyTorch port (relation_detr_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, one line each; any failure raises and the exit code is non-zero:
  1. device: nvidia-smi name and power limit, torch/CUDA/nvcc versions;
  2. build: nvcc builds the CUDA kernels from csrc/ (seconds printed);
  3. kernels against their plain PyTorch versions on the card, TF32 off, at
     the flagship's shapes, with CUDA-event times of both: msda_fwd,
     relation_bias_v4_fwd, msda_bwd (encoder Q=S=22,323, decoder Q=1100
     and 1500), the relation bias's backward (N=1100) and
     window_accumulate (encoder level 0);
  4. in-model parity: the tiny-test config on the GPU (kernels) and on the
     CPU (plain versions), same weights and inputs: the eval forward, then
     one train forward + backward with the same CDN draws, run on the CPU
     twice: as is, and sampling at the GPU's MSDA locations;
  5. the flagship config (ResNet-50, embed 256, 6+6 layers, 900 queries,
     91 classes, fp32, seeded random weights) answers 4 requests on the
     800x1344 canvas through ``inference.detect``, each going through 12
     MSDA and 5 relation-bias kernel launches; then the B=1 p50 latency and
     peak device memory;
  6. the flagship train step (``parallel.train_step.make_train_step``: CDN,
     hybrid branch, matcher, criterion, backward, clip, AdamW) on synthetic
     batches in the loader's layout: B=1 at GT capacity 100 and 16 (2
     warm-up + 5 timed steps each), B=2 at 100 (3 steps); p50 step time,
     peak memory, kernel launches and host matching seconds per step;
  7. a JSON kernel table (launches: the train step's; window_accumulate is
     off that path, so its count there is 0), then the last line
     {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.

Imports neither jax, flax, cv2 nor the JAX package. Exits non-zero, printing
no result, without a CUDA device or outside a checkout of the repository.
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
TRAIN_RUNS = ((1, 100, 2, 5), (1, 16, 2, 5), (2, 100, 0, 3))  # B, GT cap, warm-up, timed
BOXES_PER_IMAGE = 7


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


def in_turns(plain, kernel, iters_plain, iters_kernel):
    """Times as plain, kernel, kernel, plain; mean of each pair."""
    p1 = cuda_ms(plain, iters_plain)
    k1 = cuda_ms(kernel, iters_kernel)
    k2 = cuda_ms(kernel, iters_kernel)
    p2 = cuda_ms(plain, iters_plain)
    return (k1 + k2) / 2, (p1 + p2) / 2


def msda_inputs(torch, gen, num_queries, dev):
    """Encoder-like locations (token centres plus offsets of a few pixels),
    with points past every border and exactly on the borders."""
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


def relation_inputs(torch, gen, n, dev):
    """Boxes with w/h from 10**-4.5 to 1 (angles up to ~1e3 rad), one NaN
    centre (the ratio clamp makes its bias finite) and one Inf centre."""
    centres = torch.rand(1, n, 2, generator=gen, device=dev)
    wh = 10 ** (torch.rand(1, n, 2, generator=gen, device=dev) * 4.5 - 4.5)
    boxes = torch.cat([centres, wh], -1)
    boxes[0, 3, :2] = float("nan")
    boxes[0, 17, 0] = float("inf")
    src = boxes.contiguous()
    tgt = torch.roll(boxes, 5, dims=1).contiguous()
    kernel = torch.randn(64, 8, generator=gen, device=dev) * 0.1
    bias = torch.randn(8, generator=gen, device=dev) * 0.1
    return src, tgt, kernel, bias


def check_kernels(torch):
    from relation_detr_tpu_torch.ops import msda, relation_bias

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    rows = {}
    total = sum(h * w for h, w in LEVELS)
    errs, times = [], []
    for name, nq in (("encoder", total), ("decoder", 900)):
        value, locs, attn = msda_inputs(torch, gen, nq, dev)
        with torch.no_grad():
            got = msda.multi_scale_deformable_attention(value, LEVELS, locs, attn)
            want = msda.msda_reference(value, LEVELS, locs, attn)
            torch.cuda.synchronize()
            err = (got - want).abs().max().item()
            if not (err <= TOL_KERNEL):
                raise AssertionError(f"msda {name} Q={nq}: max abs err {err} > {TOL_KERNEL}")
            ms, plain_ms = in_turns(
                lambda: msda.msda_reference(value, LEVELS, locs, attn),
                lambda: msda.multi_scale_deformable_attention(value, LEVELS, locs, attn),
                5, 20,
            )
        errs.append(err)
        times.append((ms, plain_ms))
        phase(3, f"msda_fwd {name} B=1 Q={nq} S={total} H=8 D=32 L=4 P=4: "
                 f"max_abs_err {err:.3e}, kernel {ms:.4f} ms, plain {plain_ms:.4f} ms")
    rows["msda"] = dict(
        name="msda_fwd", route="cuda", source="relation_detr_tpu_torch/csrc/msda.cu",
        replaces="relation_detr_tpu/ops/msda.py:375", max_abs_err=max(errs),
        ms=times[0][0], plain_ms=times[0][1],
        decoder_ms=times[1][0], decoder_plain_ms=times[1][1],
        shape="encoder B=1 Q=S=22323 H=8 D=32 L=P=4 (decoder: Q=900)",
    )

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
    phase(3, f"relation_bias_v4_fwd B=1 N1=N2=900 H=8: max_abs_err {err:.3e}, "
             f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms")
    rows["relation"] = dict(
        name="relation_bias_v4_fwd", route="cuda",
        source="relation_detr_tpu_torch/csrc/relation_bias.cu",
        replaces="relation_detr_tpu/ops/relation_pallas.py:164", max_abs_err=err,
        ms=ms, plain_ms=plain_ms, shape="B=1 N1=N2=900 H=8 E=16",
    )
    return rows


def max_rel(got, want):
    return ((got - want).abs().max() / want.abs().max().clamp_min(1e-30)).item()


def check_backward_kernels(torch, rows):
    from relation_detr_tpu_torch.ops import msda, patch_scatter, relation_bias

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(1)
    total = sum(h * w for h, w in LEVELS)
    errs, times = [], {}
    for name, nq in (("encoder", total), ("decoder", 1100), ("hybrid decoder", 1500)):
        value, locs, attn = msda_inputs(torch, gen, nq, dev)
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
            raise AssertionError(f"msda_bwd {name} Q={nq}: max rel err (value, locations, "
                                 f"weights) {rel} > {TOL_BWD_REL}")
        ms, plain_ms = in_turns(
            plain, lambda: msda.msda_backward(value, LEVELS, locs, attn, grad_out), 3, 10)
        errs.append(err)
        times[name] = (ms, plain_ms)
        phase(3, f"msda_bwd {name} B=1 Q={nq} S={total} H=8 D=32 L=4 P=4: max rel err "
                 f"value {rel[0]:.3e}, locations {rel[1]:.3e}, weights {rel[2]:.3e} "
                 f"(max abs {err:.3e}); kernel {ms:.4f} ms, plain backward {plain_ms:.4f} ms")
        del out, inputs, want, got
    rows["msda_bwd"] = dict(
        name="msda_bwd", route="cuda", source="relation_detr_tpu_torch/csrc/msda.cu",
        replaces="relation_detr_tpu/ops/msda.py:375", max_abs_err=max(errs),
        ms=times["encoder"][0], plain_ms=times["encoder"][1],
        decoder_ms=times["decoder"][0], decoder_plain_ms=times["decoder"][1],
        hybrid_ms=times["hybrid decoder"][0], hybrid_plain_ms=times["hybrid decoder"][1],
        shape="encoder B=1 Q=S=22323 H=8 D=32 L=P=4 (decoder: Q=1100; hybrid: Q=1500)",
    )

    src, tgt, kernel, bias = relation_inputs(torch, gen, 1100, dev)
    with torch.no_grad():  # the train path's shape: 200 CDN slots + 900 queries
        fwd = relation_bias.relation_bias_v4(src, tgt, kernel, bias)
        fwd_want = relation_bias.relation_bias_v4_reference(src, tgt, kernel, bias)
        torch.cuda.synchronize()
        fwd_err = (fwd - fwd_want).abs().max().item()
    if not (fwd_err <= TOL_KERNEL):
        raise AssertionError(f"relation bias N=1100: max abs err {fwd_err} > {TOL_KERNEL}")
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
    phase(3, f"relation_bias_v4_fwd B=1 N1=N2=1100 H=8: max_abs_err {fwd_err:.3e}; relation "
             f"bias backward (RelationBiasFunction: plain separable recompute, not a kernel): "
             f"max rel err kernel {rel[0]:.3e}, bias {rel[1]:.3e}; {ms:.4f} ms, plain autograd "
             f"backward {plain_ms:.4f} ms")
    rows["relation"].update(max_abs_err=max(rows["relation"]["max_abs_err"], fwd_err),
                            max_abs_err_n1100=fwd_err, backward_ms=ms, backward_plain_ms=plain_ms)
    del out, cot

    y0s, x0s = patch_scatter.level0_origins()
    (h, w), (ph, pw) = patch_scatter.LEVEL0_CANVAS, patch_scatter.LEVEL0_WINDOW
    g = torch.randn(len(y0s), ph, pw, 256, generator=gen, device=dev)
    got = patch_scatter.window_accumulate(g, y0s, x0s, h, w)
    want = patch_scatter.window_accumulate_reference(g, y0s, x0s, h, w)
    torch.cuda.synchronize()
    if not torch.equal(got, want):
        raise AssertionError("window_accumulate: not bit-identical to the ascending "
                             f"slice-add loop (max abs err {(got - want).abs().max().item()})")
    ms, plain_ms = in_turns(
        lambda: patch_scatter.window_accumulate_reference(g, y0s, x0s, h, w),
        lambda: patch_scatter.window_accumulate(g, y0s, x0s, h, w), 5, 20)
    phase(3, f"window_accumulate level 0 {len(y0s)} windows of {ph}x{pw}x256 onto "
             f"{h}x{w}x256: bit-identical to plain, kernel {ms:.4f} ms, plain {plain_ms:.4f} ms")
    rows["window"] = dict(
        name="window_accumulate", route="cuda",
        source="relation_detr_tpu_torch/csrc/patch_scatter.cu",
        replaces="relation_detr_tpu/ops/patch_scatter.py:39", max_abs_err=0.0,
        ms=ms, plain_ms=plain_ms, shape=f"nt={len(y0s)} ph={ph} pw={pw} C=256 on {h}x{w}",
    )


class TopkRecorder:
    """Records every two-stage top-k (encoder, hybrid): selected class
    logits, boxes and indices."""

    def __init__(self):
        from relation_detr_tpu_torch.models.transformer import RelationTransformer

        self.cls = RelationTransformer
        self.select = RelationTransformer._select_topk
        self.indices = []

    def __enter__(self):
        def recording(*args):
            out = self.select(*args)
            self.indices.append([t.detach().cpu() for t in out])
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


def check_tiny_train(torch):
    from relation_detr_tpu_torch.losses.criterion import relation_detr_loss

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
        with TopkRecorder() as rec, PinnedKinks(model, record) as pins:
            outputs = model(b["images"], b["mask"], b["gt_labels"], b["gt_boxes"],
                            b["gt_valid"], train=True,
                            noise_draws={k: v.to(dev) for k, v in draws.items()})
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
    phase(4, f"tiny-test config train forward + backward (CDN + hybrid) GPU vs CPU, same "
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
    phase(4, f"the same with the CPU's kinks pinned to the GPU's side ({flips['msda']} MSDA "
             f"samples in another bilinear cell, {flips['relu']} backbone ReLU inputs of "
             f"another sign): total {pinned['total']:.6f}, loss terms within {loss_err:.3e} rel; "
             f"all {len(ratios)} grads within {err:.3e} of each leaf's max ({name}), backbone "
             f"within {bb_err:.3e}")


def run_flagship_train(torch, model, kernels):
    from relation_detr_tpu_torch.configs import train_config
    from relation_detr_tpu_torch.losses.criterion import compute_matching
    from relation_detr_tpu_torch.ops import msda, patch_scatter, relation_bias
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
        # the port's MSDA has no patch slab; msda_bwd scatters the value gradient
        "window_accumulate": (patch_scatter.window_accumulate, 0),
    }
    for fn, _ in counters.values():
        fn.launches = 0
    for bs, cap, warmup, timed in TRAIN_RUNS:
        batch = synthetic_batch(torch, gen, bs, cap, CANVAS, "cuda", REQUESTS[0])
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
                raise AssertionError(f"train step B={bs} cap={cap} #{i}: non-finite {bad}, "
                                     f"nonfinite_count {metrics['nonfinite_count']}")
            for k, (fn, expected) in counters.items():
                if fn.launches - before[k] != expected:
                    raise AssertionError(f"train step: {fn.launches - before[k]} {k} "
                                         f"launches, expected {expected}")
            if i >= warmup:
                times.append(start.elapsed_time(end))
                host.append(compute_matching.host_seconds - h0)
        peak = torch.cuda.max_memory_allocated()
        phase(6, f"flagship train step B={bs} GT capacity {cap} ({BOXES_PER_IMAGE} boxes "
                 f"per image) 800x1344 fp32: p50 {statistics.median(times):.3f} ms ("
                 f"{len(times)} steps: {', '.join(f'{t:.3f}' for t in times)}); peak memory "
                 f"{peak / 2**30:.3f} GiB; host matching {statistics.median(host):.4f} s/step; "
                 f"total_loss {metrics['total_loss']:.4f}, grad_norm {metrics['grad_norm']:.4f}, "
                 f"{len(losses)} loss terms finite")
    per_step = ", ".join(f"{k} {e}" for k, (_, e) in counters.items())
    phase(6, f"launches per step: {per_step} (the port's MSDA has no patch slab; msda_bwd "
             "scatters the value gradient)")
    moved = sum(not torch.equal(p.detach(), p0) for p, p0 in
                zip(trainable[:: max(len(trainable) // 40, 1)], start_params))
    if moved < len(start_params) // 2:
        raise AssertionError(f"only {moved}/{len(start_params)} sampled parameters moved")
    if not all(torch.equal(p.detach(), p0) for p, p0 in zip(frozen[:5], frozen_sample)):
        raise AssertionError("a frozen parameter moved")
    phase(6, f"{moved}/{len(start_params)} sampled trainable parameters moved, frozen "
             f"ones did not; {step.state.updates} updates, nonfinite_count "
             f"{step.state.nonfinite_count}")
    for key, row in (("msda_fwd", "msda"), ("msda_bwd", "msda_bwd"),
                     ("relation_bias_v4_fwd", "relation"), ("window_accumulate", "window")):
        fn, expected = counters[key]
        kernels[row]["launches"] = fn.launches
        if expected and fn.launches == 0:
            raise AssertionError(f"{key} was never launched by the train step")


def check_tiny_model(torch):
    cfg = importlib.import_module(CONFIGS + "relation_detr_resnet50_tiny_test")
    cpu_model = cfg.build_model(device="cpu", seed=1)
    gpu_model = copy.deepcopy(cpu_model).to("cuda")
    gen = torch.Generator().manual_seed(2)
    images = torch.randn(2, 256, 320, 3, generator=gen)
    mask = torch.zeros(2, 256, 320, dtype=torch.bool)
    mask[1, 192:] = True
    mask[1, :, 240:] = True
    images[mask] = 0.0
    with torch.inference_mode():
        want = cpu_model(images, mask)
        got = gpu_model(images.cuda(), mask.cuda())
    for name in ("pred_logits", "pred_boxes"):
        torch.testing.assert_close(got[name].cpu(), want[name], rtol=TOL_MODEL, atol=TOL_MODEL)
        err = (got[name].cpu() - want[name]).abs().max().item()
        phase(4, f"tiny-test config GPU (kernels) vs CPU (plain) {name} "
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
    for _ in range(5):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        detect(model, images, mask, sizes, 100)
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    phase(5, f"flagship B=1 800x1344 fp32 detect: p50 {statistics.median(times):.3f} ms "
             f"(5 runs: {', '.join(f'{t:.3f}' for t in times)}), peak memory "
             f"{peak / 2**30:.3f} GiB (max_memory_allocated over the 4 requests)")
    hook.remove()
    return model


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

    fresh = not _build.library_path().is_file()
    t0 = time.perf_counter()
    _build.load_library()
    phase(2, f"{'built' if fresh else 'reused'} "
             f"{os.path.relpath(_build.library_path(), ROOT)} and loaded it in "
             f"{time.perf_counter() - t0:.2f} s")

    seconds = {}

    def timed(n, fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        seconds[n] = seconds.get(n, 0.0) + time.perf_counter() - t0
        return out

    kernels = timed(3, check_kernels, torch)
    timed(3, check_backward_kernels, torch, kernels)
    timed(4, check_tiny_model, torch)
    timed(4, check_tiny_train, torch)
    model = timed(5, run_flagship, torch, kernels)
    timed(6, run_flagship_train, torch, model, kernels)
    phase(7, "seconds per phase: " + ", ".join(f"{n}: {t:.1f}" for n, t in seconds.items()))

    leaked = [m for m in ("jax", "flax", "cv2", "relation_detr_tpu") if m in sys.modules]
    if leaked:
        raise AssertionError(f"the port's path imported {leaked}")
    print(json.dumps({"kernels": list(kernels.values())}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
