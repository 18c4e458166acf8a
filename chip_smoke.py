#!/usr/bin/env python3
"""Smoke run of the PyTorch port (relation_detr_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, one line each; any failure raises and the exit code is non-zero:
  1. device: nvidia-smi name and power limit, torch/CUDA/nvcc versions;
  2. build: nvcc builds the CUDA kernels from csrc/ (seconds printed);
  3. kernels against their plain PyTorch versions on the card, TF32 off, at
     the flagship forward's shapes, with CUDA-event times of both;
  4. in-model parity: the tiny-test config on the GPU (kernels) and on the
     CPU (plain versions), same weights and inputs;
  5. the flagship config (ResNet-50, embed 256, 6+6 layers, 900 queries,
     91 classes, fp32, seeded random weights) answers 4 requests on the
     800x1344 canvas through ``inference.detect``, each going through 12
     MSDA and 5 relation-bias kernel launches; then the B=1 p50 latency and
     peak device memory;
  6. a JSON kernel table, then the last line
     {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.

Imports neither jax, flax, cv2 nor the JAX package. Exits non-zero, printing
no result, without a CUDA device or outside a checkout of the repository.
"""
from __future__ import annotations

import copy
import importlib
import json
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
    attn = torch.rand(1, num_queries, h_, l_, p_, generator=gen, device=dev)
    attn = attn / attn.sum(dim=(-2, -1), keepdim=True)
    return value, locs.contiguous(), attn.contiguous()


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
    model.register_forward_hook(lambda module, args, out: raw.update(out))
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
    kernels["msda"]["launches"] = msda.multi_scale_deformable_attention.launches
    kernels["relation"]["launches"] = relation_bias.relation_bias_v4.launches
    for row in kernels.values():
        if row["launches"] == 0:
            raise AssertionError(f"{row['name']} was never launched on the main path")
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

    kernels = check_kernels(torch)
    check_tiny_model(torch)
    run_flagship(torch, kernels)

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
