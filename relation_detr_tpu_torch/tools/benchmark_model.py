"""Model benchmark: parameters, FLOPs, and the eval forward's latency.

The port's counterpart of the root ``tools/benchmark_model.py``:

    python -m relation_detr_tpu_torch.tools.benchmark_model \\
        [--model-config relation_detr_tpu_torch/configs/relation_detr/...py] \\
        [--height 800 --width 1344 --batch 1 --reps 50] [--device cuda]

Prints the parameters (with the buffers, as the JAX tool counts every
variable) in M; the FLOPs of one eval forward in G from
``torch.utils.flop_counter.FlopCounterMode``, the hand kernels counted by the
formulas of ``utils/flops.py``, and the share the kernels' ops carry; then,
on a card, the forward's latency: p50 / p90 over ``--reps`` single calls,
each between two CUDA events and synchronised, and the queued ms per
iteration and images/s over K = max(reps, 10) calls between two events.
Weights are drawn from seed 0, images from ``RandomState(0)``, no padding.

Unlike the JAX tool it prints no "bytes accessed" line: XLA's cost analysis
gives that number, and PyTorch has no counterpart. Without a card
(``--device cpu``) the latency is not measured.
"""
from __future__ import annotations

import argparse
import os
from typing import Dict

import numpy as np
import torch

from relation_detr_tpu_torch.utils.config import Config
from relation_detr_tpu_torch.utils.flops import count_flops

DEFAULT_CONFIG = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    "configs", "relation_detr", "relation_detr_resnet50_800_1333.py",
)


def parse_args(argv=None):
    p = argparse.ArgumentParser("relation_detr_tpu_torch model benchmark")
    p.add_argument("--model-config", default=DEFAULT_CONFIG)
    p.add_argument("--height", type=int, default=800)
    p.add_argument("--width", type=int, default=1344)
    p.add_argument("--batch", type=int, default=1)
    p.add_argument("--reps", type=int, default=50)
    p.add_argument("--device", default="cuda")
    return p.parse_args(argv)


def latency(forward, reps: int) -> Dict[str, float]:
    """p50 / p90 ms of ``reps`` single calls of ``forward`` (CUDA events, a
    synchronise after each) and the queued ms per call over max(reps, 10)."""
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    single = []
    for _ in range(reps):
        start.record()
        forward()
        end.record()
        end.synchronize()
        single.append(start.elapsed_time(end))
    k = max(reps, 10)
    start.record()
    for _ in range(k):
        forward()
    end.record()
    end.synchronize()
    return {"p50_ms": float(np.percentile(single, 50)), "p90_ms": float(np.percentile(single, 90)),
            "queued_ms": start.elapsed_time(end) / k, "queued_calls": k}


def main(argv=None) -> Dict:
    """Prints and returns ``params``, ``flops``, ``op_flops`` (by op) and, on a
    card, ``latency``'s numbers and ``images_per_s``."""
    args = parse_args(argv)
    device = torch.device(args.device)
    model = Config(args.model_config).build_model(device=device).requires_grad_(False)
    rng = np.random.RandomState(0)
    images = torch.from_numpy(
        rng.randn(args.batch, args.height, args.width, 3).astype(np.float32)).to(device)
    mask = torch.zeros(args.batch, args.height, args.width, dtype=torch.bool, device=device)
    n_params = sum(t.numel() for t in (*model.parameters(), *model.buffers()))
    print(f"params: {n_params / 1e6:.2f} M")
    _, flops, op_flops = count_flops(model, images, mask)
    share = sum(op_flops.values()) / flops
    print(f"flops: {flops / 1e9:.1f} G (FlopCounterMode with utils/flops.py's kernel formulas, "
          f"batch {args.batch}); the kernels' ops {100 * share:.2f}%: "
          + ", ".join(f"{name} {v / 1e9:.3f} G" for name, v in op_flops.items()))
    result = {"params": n_params, "flops": flops, "op_flops": op_flops, "op_share": share}
    if device.type != "cuda":
        print("latency: not measured (no card)")
        return result

    def forward():
        with torch.inference_mode():
            return model(images, mask)

    forward()
    torch.cuda.synchronize()
    result.update(latency(forward, args.reps))
    result["images_per_s"] = args.batch / (result["queued_ms"] / 1e3)
    print(f"inference ({torch.cuda.get_device_name(device)}; single call, synchronised): "
          f"p50 {result['p50_ms']:.3f} ms  p90 {result['p90_ms']:.3f} ms")
    print(f"inference (queued x{result['queued_calls']}): {result['queued_ms']:.3f} ms/iter  "
          f"({result['images_per_s']:.2f} img/s)")
    return result


if __name__ == "__main__":
    main()
