"""Convert a reference Relation-DETR torch checkpoint (.pth) to the JAX
package's ``.npz`` layout, which the port's ``utils/weights.py::load_weights``
reads. The port's own copy of the root ``tools/convert_torch_weights.py``
(``convert_state_dict``, numpy only, and ``main``):

    python -m relation_detr_tpu_torch.tools.convert_torch_weights \\
        --torch-checkpoint relation_detr.pth --output converted.npz \\
        [--model-config relation_detr_tpu_torch/configs/relation_detr/...py] [--device cuda]

It maps the reference's state_dict names onto the flax param paths and
layouts:

- conv kernels OIHW -> HWIO; linear kernels (out, in) -> (in, out)
- nn.MultiheadAttention in_proj_weight (3C, C) splits into q/k/v kernels
- FrozenBatchNorm stats land in the batch_stats collection
- 1x1 convs used as per-feature projections (relation pos_proj) flatten to
  Dense kernels

``--model-config`` validates the written file against the port's model of
that config: ``load_weights(model, output, strict=False)``'s report, the
tensors loaded, missing (the file lacks them) and mismatched in shape (the
JAX tool checks the JAX model's parameter tree instead).
"""
from __future__ import annotations

import argparse
import re
from typing import Dict

import numpy as np




def _t(x):
    return np.asarray(x.detach().cpu().numpy() if hasattr(x, "detach") else x)


def _linear(out: Dict, prefix: str, w, b=None):
    out[f"{prefix}/kernel"] = _t(w).T
    if b is not None:
        out[f"{prefix}/bias"] = _t(b)


def _conv(out: Dict, prefix: str, w, b=None):
    out[f"{prefix}/kernel"] = _t(w).transpose(2, 3, 1, 0)  # OIHW -> HWIO
    if b is not None:
        out[f"{prefix}/bias"] = _t(b)


def _layernorm(out: Dict, prefix: str, w, b):
    out[f"{prefix}/scale"] = _t(w)
    out[f"{prefix}/bias"] = _t(b)


def convert_state_dict(sd: Dict[str, np.ndarray]):
    """Returns (params_flat, batch_stats_flat) keyed by '/'-joined paths."""
    params: Dict[str, np.ndarray] = {}
    stats: Dict[str, np.ndarray] = {}
    handled = set()

    def take(key):
        handled.add(key)
        return sd[key]

    def has(key):
        return key in sd

    # ---- backbone (torchvision resnet names under backbone.body.*; a bare
    # torchvision ImageNet checkpoint with top-level conv1/layerN keys also
    # converts — the reference loads those URLs directly, resnet.py:344-414) ----
    bb_prefixes = [p for p in ("backbone.body.", "backbone.", "") if any(
        k.startswith(p + "conv1.weight") for k in sd)]
    bb = bb_prefixes[0] if bb_prefixes else "backbone.body."
    if has(bb + "conv1.weight"):
        _conv(params, "backbone/conv1", take(bb + "conv1.weight"))
        for stat in ("weight", "bias", "running_mean", "running_var"):
            stats[f"backbone/bn1/{stat}"] = _t(take(f"{bb}bn1.{stat}"))
    layer_re = re.compile(rf"^{re.escape(bb)}layer(\d+)\.(\d+)\.(.+)$")
    for key in list(sd):
        m = layer_re.match(key)
        if not m:
            continue
        stage, block, rest = int(m.group(1)), int(m.group(2)), m.group(3)
        dst = f"backbone/layer{stage}_{block}"
        if ".conv_offset." in rest or ".conv_mask." in rest:
            # DCN variant (DeformConv2dPack offset/mask convs,
            # reference deform_conv2d_pack.py:9-81)
            conv, sub, kind = rest.split(".")
            if kind == "weight":
                _conv(params, f"{dst}/{conv}/{sub}", take(key))
            else:
                params[f"{dst}/{conv}/{sub}/bias"] = _t(take(key))
        elif rest == "conv2.weight" and has(
            f"{bb}layer{stage}.{block}.conv2.conv_offset.weight"
        ):
            # torchvision DeformConv2d weight (O, I//g, kh, kw) -> our tap
            # kernel (kh*kw, I//g, O)
            w = _t(take(key)).transpose(2, 3, 1, 0)
            params[f"{dst}/conv2/kernel"] = w.reshape(-1, *w.shape[2:])
        elif rest.startswith("conv") and rest.endswith(".weight"):
            _conv(params, f"{dst}/{rest.split('.')[0]}", take(key))
        elif rest.startswith("bn"):
            name, stat = rest.split(".")
            stats[f"{dst}/{name}/{stat}"] = _t(take(key))
        elif rest.startswith("downsample.0.weight"):
            _conv(params, f"{dst}/downsample_conv", take(key))
        elif rest.startswith("downsample.1."):
            stat = rest.split(".")[-1]
            stats[f"{dst}/downsample_bn/{stat}"] = _t(take(key))

    # ---- backbone: swin (torchvision layout under backbone.0.features.*,
    # reference swin.py:780-789; v2 adds logit_scale + cpb_mlp) ----
    swin_prefixes = [p for p in ("backbone.0.", "backbone.", "") if
                     (p + "features.0.0.weight") in sd]
    if swin_prefixes:
        sp = swin_prefixes[0] + "features."
        _conv(params, "backbone/patch_embed", take(sp + "0.0.weight"),
              take(sp + "0.0.bias"))
        _layernorm(params, "backbone/patch_norm", take(sp + "0.2.weight"),
                   take(sp + "0.2.bias"))
        for stage in range(4):
            if stage > 0 and has(f"{sp}{2 * stage}.reduction.weight"):
                _linear(params, f"backbone/merge{stage}/reduction",
                        take(f"{sp}{2 * stage}.reduction.weight"))
                _layernorm(params, f"backbone/merge{stage}/norm",
                           take(f"{sp}{2 * stage}.norm.weight"),
                           take(f"{sp}{2 * stage}.norm.bias"))
            j = 0
            while has(f"{sp}{2 * stage + 1}.{j}.norm1.weight"):
                src = f"{sp}{2 * stage + 1}.{j}"
                dst = f"backbone/stage{stage}_block{j}"
                for n in ("norm1", "norm2"):
                    _layernorm(params, f"{dst}/{n}", take(f"{src}.{n}.weight"),
                               take(f"{src}.{n}.bias"))
                _linear(params, f"{dst}/attn/qkv", take(f"{src}.attn.qkv.weight"),
                        take(f"{src}.attn.qkv.bias"))
                _linear(params, f"{dst}/attn/proj", take(f"{src}.attn.proj.weight"),
                        take(f"{src}.attn.proj.bias"))
                if has(f"{src}.attn.logit_scale"):  # v2
                    params[f"{dst}/attn/logit_scale"] = _t(
                        take(f"{src}.attn.logit_scale"))
                    _linear(params, f"{dst}/attn/cpb_fc1",
                            take(f"{src}.attn.cpb_mlp.0.weight"),
                            take(f"{src}.attn.cpb_mlp.0.bias"))
                    _linear(params, f"{dst}/attn/cpb_fc2",
                            take(f"{src}.attn.cpb_mlp.2.weight"))
                else:
                    params[f"{dst}/attn/relative_position_bias_table"] = _t(
                        take(f"{src}.attn.relative_position_bias_table"))
                _linear(params, f"{dst}/mlp_fc1", take(f"{src}.mlp.0.weight"),
                        take(f"{src}.mlp.0.bias"))
                _linear(params, f"{dst}/mlp_fc2", take(f"{src}.mlp.3.weight"),
                        take(f"{src}.mlp.3.bias"))
                # static buffers we recompute at trace time
                for buf in ("attn.relative_position_index",
                            "attn.relative_coords_table"):
                    if has(f"{src}.{buf}"):
                        handled.add(f"{src}.{buf}")
                j += 1

    # ---- neck ----
    for key in list(sd):
        m = re.match(r"^neck\.convs\.(\d+)\.(\d+)\.(weight|bias)$", key)
        if not m:
            continue
        idx, sub, kind = int(m.group(1)), int(m.group(2)), m.group(3)
        if sub == 0:  # conv
            if kind == "weight":
                _conv(params, f"neck/convs_{idx}/conv", take(key))
            else:
                params[f"neck/convs_{idx}/conv/bias"] = _t(take(key))
        else:  # group norm
            params[f"neck/convs_{idx}/norm/{'scale' if kind == 'weight' else 'bias'}"] = _t(take(key))

    # ---- transformer ----
    t = "transformer."

    def msda(src, dst):
        for name in ("sampling_offsets", "attention_weights", "value_proj", "output_proj"):
            _linear(params, f"{dst}/{name}", take(f"{src}.{name}.weight"),
                    take(f"{src}.{name}.bias"))

    def ffn_norms(src, dst, norm_names):
        _linear(params, f"{dst}/linear1", take(f"{src}.linear1.weight"),
                take(f"{src}.linear1.bias"))
        _linear(params, f"{dst}/linear2", take(f"{src}.linear2.weight"),
                take(f"{src}.linear2.bias"))
        for n in norm_names:
            _layernorm(params, f"{dst}/{n}", take(f"{src}.{n}.weight"),
                       take(f"{src}.{n}.bias"))

    def mlp(src, dst, n_layers):
        for i in range(n_layers):
            _linear(params, f"{dst}/layers_{i}", take(f"{src}.layers.{i}.weight"),
                    take(f"{src}.layers.{i}.bias"))

    # encoder layers
    enc_idx = 0
    while has(f"{t}encoder.layers.{enc_idx}.linear1.weight"):
        src = f"{t}encoder.layers.{enc_idx}"
        dst = f"transformer/encoder/layers_{enc_idx}"
        msda(f"{src}.self_attn", f"{dst}/self_attn")
        ffn_norms(src, dst, ("norm1", "norm2"))
        enc_idx += 1
    # memory fusion (Sequential: 0 linear, 2 linear, 3 LN)
    if has(f"{t}encoder.memory_fusion.0.weight"):
        _linear(params, "transformer/encoder/fusion_0",
                take(f"{t}encoder.memory_fusion.0.weight"),
                take(f"{t}encoder.memory_fusion.0.bias"))
        _linear(params, "transformer/encoder/fusion_1",
                take(f"{t}encoder.memory_fusion.2.weight"),
                take(f"{t}encoder.memory_fusion.2.bias"))
        _layernorm(params, "transformer/encoder/fusion_norm",
                   take(f"{t}encoder.memory_fusion.3.weight"),
                   take(f"{t}encoder.memory_fusion.3.bias"))

    # decoder layers
    dec_idx = 0
    while has(f"{t}decoder.layers.{dec_idx}.linear1.weight"):
        src = f"{t}decoder.layers.{dec_idx}"
        dst = f"transformer/decoder/layers_{dec_idx}"
        in_w = _t(take(f"{src}.self_attn.in_proj_weight"))
        in_b = _t(take(f"{src}.self_attn.in_proj_bias"))
        c = in_w.shape[1]
        for i, name in enumerate(("q_proj", "k_proj", "v_proj")):
            params[f"{dst}/self_attn/{name}/kernel"] = in_w[i * c:(i + 1) * c].T
            params[f"{dst}/self_attn/{name}/bias"] = in_b[i * c:(i + 1) * c]
        _linear(params, f"{dst}/self_attn/out_proj",
                take(f"{src}.self_attn.out_proj.weight"),
                take(f"{src}.self_attn.out_proj.bias"))
        msda(f"{src}.cross_attn", f"{dst}/cross_attn")
        ffn_norms(src, dst, ("norm1", "norm2", "norm3"))
        dec_idx += 1

    # decoder heads / embeds (absent in backbone-only checkpoints)
    if has(f"{t}decoder.ref_point_head.layers.0.weight"):
        mlp(f"{t}decoder.ref_point_head", "transformer/decoder/ref_point_head", 2)
        mlp(f"{t}decoder.query_scale", "transformer/decoder/query_scale", 2)
        _layernorm(params, "transformer/decoder/norm",
                   take(f"{t}decoder.norm.weight"), take(f"{t}decoder.norm.bias"))
    for i in range(dec_idx):
        _linear(params, f"transformer/decoder/class_head_{i}",
                take(f"{t}decoder.class_head.{i}.weight"),
                take(f"{t}decoder.class_head.{i}.bias"))
        mlp(f"{t}decoder.bbox_head.{i}", f"transformer/decoder/bbox_head_{i}", 3)
    if has(f"{t}decoder.position_relation_embedding.pos_proj.0.weight"):
        w = _t(take(f"{t}decoder.position_relation_embedding.pos_proj.0.weight"))
        params["transformer/decoder/position_relation_embedding/pos_proj/kernel"] = (
            w[:, :, 0, 0].T
        )
        params["transformer/decoder/position_relation_embedding/pos_proj/bias"] = _t(
            take(f"{t}decoder.position_relation_embedding.pos_proj.0.bias")
        )

    # two-stage pieces
    for name, dst in (
        ("level_embeds", "transformer/level_embeds"),
        ("tgt_embed.weight", "transformer/tgt_embed"),
        ("hybrid_tgt_embed.weight", "transformer/hybrid_tgt_embed"),
        ("refpoint_embed.weight", "transformer/refpoint_embed"),
    ):
        if has(t + name):
            params[dst] = _t(take(t + name))
    if has(f"{t}enc_output.weight"):
        _linear(params, "transformer/enc_output", take(f"{t}enc_output.weight"),
                take(f"{t}enc_output.bias"))
        _layernorm(params, "transformer/enc_output_norm",
                   take(f"{t}enc_output_norm.weight"),
                   take(f"{t}enc_output_norm.bias"))
    for head in ("encoder_class_head", "hybrid_class_head"):
        if has(f"{t}{head}.weight"):
            _linear(params, f"transformer/{head}", take(f"{t}{head}.weight"),
                    take(f"{t}{head}.bias"))
    for head in ("encoder_bbox_head", "hybrid_bbox_head"):
        if has(f"{t}{head}.layers.0.weight"):
            mlp(f"{t}{head}", f"transformer/{head}", 3)

    # denoising label encoder
    if has("denoising_generator.label_encoder.weight"):
        params["denoising_generator/label_encoder/embedding"] = _t(
            take("denoising_generator.label_encoder.weight")
        )

    leftover = [k for k in sd if k not in handled and not k.startswith("criterion")
                and "_classes_" not in k and not re.search(r"(layer\d+\.\d+\.)", k)]
    return params, stats, leftover



def parse_args(argv=None):
    p = argparse.ArgumentParser("relation_detr_tpu_torch convert_torch_weights")
    p.add_argument("--torch-checkpoint", required=True)
    p.add_argument("--model-config", default=None,
                   help="if given, validate against the port's model of this config")
    p.add_argument("--output", required=True)
    p.add_argument("--device", default="cuda", help="where --model-config's model is built")
    return p.parse_args(argv)


def main(argv=None) -> Dict:
    """Converts; returns the flat arrays written and, with
    ``--model-config``, ``load_weights``'s report."""
    args = parse_args(argv)
    import torch

    ckpt = torch.load(args.torch_checkpoint, map_location="cpu", weights_only=False)
    sd = ckpt.get("model", ckpt.get("state_dict", ckpt))
    params, stats, leftover = convert_state_dict(sd)
    if leftover:
        print(f"warning: {len(leftover)} unconverted keys, e.g. {leftover[:8]}")

    flat = {f"params/{k}": v for k, v in params.items()}
    flat.update({f"batch_stats/{k}": v for k, v in stats.items()})
    np.savez(args.output, **flat)
    print(f"wrote {len(flat)} arrays to {args.output}")
    result = {"arrays": flat}
    if args.model_config:
        from relation_detr_tpu_torch.utils.config import Config
        from relation_detr_tpu_torch.utils.weights import load_weights

        model = Config(args.model_config).build_model(device=args.device)
        report = load_weights(model, args.output, strict=False)
        total = sum(len(report[k]) for k in ("loaded", "missing", "mismatched"))
        print(f"matched {len(report['loaded'])}/{total} model tensors; "
              f"{len(report['missing'])} missing, {len(report['mismatched'])} mismatched in shape")
        for key in report["missing"][:10]:
            print("  missing:", key)
        for key, got, want in report["mismatched"][:10]:
            print(f"  mismatched: {key} file {got} model {want}")
        result["report"] = report
    return result


if __name__ == "__main__":
    main()
