"""Export the eval forward and ``post_process`` as a ``torch.export`` program.

The port's counterpart of the root ``tools/export_model.py``:

    python -m relation_detr_tpu_torch.tools.export_model --output model.pt2 \\
        [--model-config relation_detr_tpu_torch/configs/relation_detr/...py] \\
        [--checkpoint weights.npz] [--height 800 --width 1344] [--verify] \\
        [--graph-out graph.txt] [--device cuda]

The program maps (images (1, H, W, 3) normalised float, mask (1, H, W)
bool, target_sizes (1, 2) float (h, w)) to (scores, labels, boxes), the
config's ``select_box_nums_for_evaluation`` top-scored detections, at the
fixed canvas, as the JAX tool's ``build_serving_fn``. It is traced under
``torch.no_grad()`` with the MSDA form and relation version set at the time
(``ops.msda.set_msda_defaults``, ``ops.relation_bias.set_fused_relation``),
and written with ``torch.export.save``; the hand kernels are in it as the
ops of ``ops/library.py``, so the loaded program launches them (a loader
imports ``relation_detr_tpu_torch.ops.library`` and calls ``load_ops()``
first). ``--graph-out`` writes the exported graph as text (the JAX tool's
``--mlir-out``).

``--verify`` reads the file back from disk, runs it on
``RandomState(0).randn`` images and compares with the live model at rtol
1e-3 / atol 1e-5, labels equal; a corrupted file fails. Without
``--checkpoint`` the model keeps its weights drawn from seed 0.
"""
from __future__ import annotations

import argparse
import os
import time
from typing import Dict, Optional

import numpy as np
import torch

from relation_detr_tpu_torch.models.post_process import post_process
from relation_detr_tpu_torch.ops import library
from relation_detr_tpu_torch.utils.config import Config
from relation_detr_tpu_torch.utils.weights import load_weights

DEFAULT_CONFIG = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    "configs", "relation_detr", "relation_detr_resnet50_800_1333.py",
)
RTOL, ATOL = 1e-3, 1e-5


class ServingModule(torch.nn.Module):
    """The eval forward and ``post_process``: (images, mask, target_sizes)
    -> (scores, labels, boxes)."""

    def __init__(self, model: torch.nn.Module, select_box_nums: int):
        super().__init__()
        self.model = model
        self.select_box_nums = select_box_nums

    def forward(self, images, mask, target_sizes):
        out = self.model(images, mask)
        det = post_process(out["pred_logits"], out["pred_boxes"], target_sizes,
                           self.select_box_nums)
        return det["scores"], det["labels"], det["boxes"]


def build_serving_module(model_config: str, height: int, width: int,
                         checkpoint: Optional[str] = None, device="cuda"):
    """(serving module, example (images, mask, target_sizes)) at B=1 on the
    (height, width) canvas, zero images and no padding."""
    cfg = Config(model_config)
    model = cfg.build_model(device=device)
    if checkpoint:
        load_weights(model, checkpoint)
    serving = ServingModule(model, cfg.get("select_box_nums_for_evaluation", 300)).eval()
    images = torch.zeros(1, height, width, 3, device=device)
    mask = torch.zeros(1, height, width, dtype=torch.bool, device=device)
    sizes = torch.tensor([[float(height), float(width)]], device=device)
    return serving, (images, mask, sizes)


def export(serving: torch.nn.Module, example) -> torch.export.ExportedProgram:
    """``torch.export.export`` of ``serving`` on ``example`` under no_grad."""
    with torch.no_grad():
        return torch.export.export(serving, tuple(example))


def load(path: str) -> torch.export.ExportedProgram:
    """A saved program, its ops registered first."""
    library.load_ops()
    return torch.export.load(path)


def verify(program: torch.export.ExportedProgram, serving: torch.nn.Module, example) -> Dict:
    """Run ``program`` and ``serving`` on ``RandomState(0).randn`` images;
    raises unless scores and boxes agree at rtol 1e-3 / atol 1e-5 and the
    labels are equal. Returns the max abs differences."""
    images, mask, sizes = example
    x = torch.from_numpy(np.random.RandomState(0).randn(*images.shape).astype(np.float32))
    x = x.to(images.device)
    with torch.no_grad():
        got = program.module()(x, mask, sizes)
        want = serving(x, mask, sizes)
    diffs = {}
    for name, a, b in zip(("scores", "labels", "boxes"), got, want):
        if name == "labels":
            if not torch.equal(a, b):
                raise AssertionError(f"verify: labels differ at "
                                     f"{int((a != b).sum())} of {a.numel()} detections")
            continue
        np.testing.assert_allclose(a.float().cpu().numpy(), b.float().cpu().numpy(),
                                   rtol=RTOL, atol=ATOL, err_msg=name)
        diffs[name] = float((a.float() - b.float()).abs().max())
    return diffs


def parse_args(argv=None):
    p = argparse.ArgumentParser("relation_detr_tpu_torch export")
    p.add_argument("--model-config", default=DEFAULT_CONFIG)
    p.add_argument("--checkpoint", default=None, help="the JAX package's .npz weight file")
    p.add_argument("--output", required=True, help="the program, torch.export.save's file")
    p.add_argument("--graph-out", default=None, help="also write the exported graph as text")
    p.add_argument("--height", type=int, default=800)
    p.add_argument("--width", type=int, default=1344)
    p.add_argument("--verify", action="store_true")
    p.add_argument("--device", default="cuda")
    return p.parse_args(argv)


def main(argv=None) -> Dict:
    """Export (and verify); returns the seconds of the export, the save and
    the load, the file's bytes and ``verify``'s differences."""
    args = parse_args(argv)
    serving, example = build_serving_module(args.model_config, args.height, args.width,
                                            args.checkpoint, args.device)
    t0 = time.perf_counter()
    program = export(serving, example)
    result = {"export_s": time.perf_counter() - t0}
    t0 = time.perf_counter()
    torch.export.save(program, args.output)
    result["save_s"] = time.perf_counter() - t0
    result["bytes"] = os.path.getsize(args.output)
    print(f"exported in {result['export_s']:.3f} s; wrote {result['bytes']} bytes "
          f"(torch.export) to {args.output}")
    if args.graph_out:
        with open(args.graph_out, "w") as f:
            f.write(str(program.graph_module.code))
        print(f"wrote the exported graph to {args.graph_out}")
    if args.verify:
        t0 = time.perf_counter()
        reloaded = load(args.output)  # the round trip goes through the disk
        result["load_s"] = time.perf_counter() - t0
        result["verify"] = verify(reloaded, serving, example)
        result["program"] = reloaded
        print(f"verify: the program read back from disk matches the live model "
              f"(rtol {RTOL}, atol {ATOL}; labels equal): {result['verify']}")
    result["serving"], result["example"] = serving, example
    return result


if __name__ == "__main__":
    main()
