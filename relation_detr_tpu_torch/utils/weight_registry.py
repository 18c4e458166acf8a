"""Pretrained-weight name resolution: the JAX package's arch -> URL tables
(``relation_detr_tpu/utils/weight_registry.py``), stdlib only.

The tables name where each upstream torch checkpoint was published; nothing
here downloads. A name resolves to a LOCAL converted ``.npz`` file, the JAX
package's weight format that ``utils/weights.py::load_weights`` reads:
fetch the ``.pth`` elsewhere, convert it once with
``tools/convert_torch_weights.py``, drop it in a cache dir, and the short
name works afterwards.

Resolution order for ``resolve_pretrained(name)``, as the JAX package's:
  1. ``name`` is an existing file path -> returned as-is.
  2. ``<name>.npz`` (and the URL basename's stem ``.npz``) under each cache
     dir: ``$RELATION_DETR_WEIGHTS_DIR`` then ``~/.cache/relation_detr_tpu``
     (the JAX package's directories, so both read one cache).
  3. Registered but not cached -> ``FileNotFoundError`` carrying the upstream
     URL and the conversion command; not registered -> ``KeyError``.
"""
from __future__ import annotations

import os
from typing import Dict, Optional

_TV = "https://download.pytorch.org/models"
_XQ = "https://github.com/xiuqhou/pretrained_weights/releases/download"
_FN = "https://github.com/microsoft/FocalNet/releases/download/v1.0.0"
_RD = "https://github.com/xiuqhou/Relation-DETR/releases/download"

#: name → upstream torch checkpoint URL, the JAX package's table.
WEIGHT_URLS: Dict[str, str] = {
    # --- ResNet family (resnet.py:344-366) ---
    "resnet18": f"{_TV}/resnet18-f37072fd.pth",
    "resnet34": f"{_TV}/resnet34-b627a593.pth",
    "resnet50_v1": f"{_TV}/resnet50-0676ba61.pth",
    "resnet50_v2": f"{_TV}/resnet50-11ad3fa6.pth",
    "resnet101_v1": f"{_TV}/resnet101-63fe2227.pth",
    "resnet101_v2": f"{_TV}/resnet101-cd907fc2.pth",
    "resnet152_v1": f"{_TV}/resnet152-394f9c45.pth",
    "resnet152_v2": f"{_TV}/resnet152-f82ba261.pth",
    "resnext50_32x4d_v1": f"{_TV}/resnext50_32x4d-7cdf4587.pth",
    "resnext50_32x4d_v2": f"{_TV}/resnext50_32x4d-1a0047aa.pth",
    "resnext101_32x8d_v1": f"{_TV}/resnext101_32x8d-8ba56ff5.pth",
    "resnext101_32x8d_v2": f"{_TV}/resnext101_32x8d-110c445d.pth",
    "resnext101_64x4d": f"{_TV}/resnext101_64x4d-173b62eb.pth",
    "wide_resnet50_2_v1": f"{_TV}/wide_resnet50_2-95faca4d.pth",
    "wide_resnet50_2_v2": f"{_TV}/wide_resnet50_2-9ba9bcbe.pth",
    "wide_resnet101_2_v1": f"{_TV}/wide_resnet101_2-32ee1156.pth",
    "wide_resnet101_2_v2": f"{_TV}/wide_resnet101_2-d733dc28.pth",
    "resnext101_32x4d": f"{_XQ}/v1.0.1-beta/resnext101_32x4d-e0fa3dd5.pth",
    # --- Swin family (swin.py:632-677) ---
    "swin_t": f"{_TV}/swin_t-704ceda3.pth",
    "swin_s": f"{_TV}/swin_s-5e29d889.pth",
    "swin_b": f"{_TV}/swin_b-68c6b09e.pth",
    "swin_v2_t": f"{_TV}/swin_v2_t-b137f0e2.pth",
    "swin_v2_s": f"{_TV}/swin_v2_s-637d8ceb.pth",  # torchvision entry the reference skips
    "swin_v2_b": f"{_TV}/swin_v2_b-781e5279.pth",
    "swin_t_in1k": f"{_XQ}/v1.0.2-beta/swin_tiny_patch4_window7_224.pth",
    "swin_t_in22k": f"{_XQ}/v1.0.2-beta/swin_tiny_patch4_window7_224_22k.pth",
    "swin_t_in22kto1k": f"{_XQ}/v1.0.2-beta/swin_tiny_patch4_window7_224_22kto1k.pth",
    "swin_s_in1k": f"{_XQ}/v1.0.2-beta/swin_small_patch4_window7_224.pth",
    "swin_s_in22k": f"{_XQ}/v1.0.2-beta/swin_small_patch4_window7_224_22k.pth",
    "swin_s_in22kto1k": f"{_XQ}/v1.0.2-beta/swin_small_patch4_window7_224_22kto1k_finetune.pth",
    "swin_b_in1k": f"{_XQ}/v1.0.2-beta/swin_base_patch4_window7_224.pth",
    "swin_b_in22k": f"{_XQ}/v1.0.2-beta/swin_base_patch4_window7_224_22k.pth",
    "swin_b_in22kto1k": f"{_XQ}/v1.0.2-beta/swin_base_patch4_window7_224_22kto1k.pth",
    "swin_b_384_in22k": f"{_XQ}/v1.0.2-beta/swin_base_patch4_window12_384_22k.pth",
    "swin_b_384_in22kto1k": f"{_XQ}/v1.0.2-beta/swin_base_patch4_window12_384_22kto1k.pth",
    "swin_l_in22k": f"{_XQ}/v1.0.2-beta/swin_large_patch4_window7_224_22k.pth",
    "swin_l_in22kto1k": f"{_XQ}/v1.0.2-beta/swin_large_patch4_window7_224_22kto1k.pth",
    "swin_l_384_in22k": f"{_XQ}/v1.0.2-beta/swin_large_patch4_window12_384_22k.pth",
    "swin_l_384_in22kto1k": f"{_XQ}/v1.0.2-beta/swin_large_patch4_window12_384_22kto1k.pth",
    # --- FocalNet family (focalnet.py:379-405) ---
    "focalnet_tiny_srf": f"{_FN}/focalnet_tiny_srf.pth",
    "focalnet_tiny_lrf": f"{_FN}/focalnet_tiny_lrf.pth",
    "focalnet_small_srf": f"{_FN}/focalnet_small_srf.pth",
    "focalnet_small_lrf": f"{_FN}/focalnet_small_lrf.pth",
    "focalnet_base_srf": f"{_FN}/focalnet_base_srf.pth",
    "focalnet_base_lrf": f"{_FN}/focalnet_base_lrf.pth",
    "focalnet_large_lrf_384": f"{_FN}/focalnet_large_lrf_384.pth",
    "focalnet_large_lrf_384_fl4": f"{_FN}/focalnet_large_lrf_384_fl4.pth",
    "focalnet_xlarge_lrf_384": f"{_FN}/focalnet_xlarge_lrf_384.pth",
    "focalnet_xlarge_lrf_384_fl4": f"{_FN}/focalnet_xlarge_lrf_384_fl4.pth",
    "focalnet_large_fl4_dino_o365":
        "https://huggingface.co/microsoft/focalnet-large-fl4-dino-o365/resolve/main/focalnet_large_fl4_pretrained_on_o365.pth",
    "focalnet_large_fl4_dino_o365_cocoft":
        "https://huggingface.co/microsoft/focalnet-large-fl4-dino-o365-cocoft/resolve/main/focalnet_large_fl4_o365_finetuned_on_coco.pth",
    # --- ConvNeXt family (convnext.py:171-177) ---
    "conv_t": f"{_TV}/convnext_tiny-983f1562.pth",
    "conv_s": f"{_TV}/convnext_small-0c510722.pth",
    "conv_b": f"{_TV}/convnext_base-6075fbad.pth",
    "conv_l": f"{_TV}/convnext_large-ea097f82.pth",
    # --- ViT family (vit.py:744-770) ---
    "vit_b_16": f"{_TV}/vit_b_16-c867db91.pth",
    "vit_b_16_swag": f"{_TV}/vit_b_16_swag-9ac1b537.pth",
    "vit_b_16_lc_swag": f"{_TV}/vit_b_16_lc_swag-4e70ced5.pth",
    "vit_b_32": f"{_TV}/vit_b_32-d86f8d99.pth",
    "vit_l_16": f"{_TV}/vit_l_16-852ce7e3.pth",
    "vit_l_16_swag": f"{_TV}/vit_l_16_swag-4f3808c9.pth",
    "vit_l_16_lc_swag": f"{_TV}/vit_l_16_lc_swag-4d563306.pth",
    "vit_l_32": f"{_TV}/vit_l_32-c7638314.pth",
    "vit_h_14_swag": f"{_TV}/vit_h_14_swag-80465313.pth",
    "vit_h_14_lc_swag": f"{_TV}/vit_h_14_lc_swag-c1eb923e.pth",
    "eva02_B_pt_in21k_p14":
        "https://hf-mirror.com/Yuxin-CV/EVA-02/raw/main/eva02/pt/eva02_B_pt_in21k_p14.pt",
    "eva02_B_pt_in21k_p14to16":
        "https://hf-mirror.com/Yuxin-CV/EVA-02/raw/main/eva02/pt/eva02_B_pt_in21k_p14to16.pt",
    # --- Relation-DETR release detectors (README.md:29-58) ---
    "relation_detr_resnet50_800_1333_coco_1x":
        f"{_RD}/v1.0.0/relation_detr_resnet50_800_1333_coco_1x.pth",
    "relation_detr_resnet50_800_1333_coco_2x":
        f"{_RD}/v1.0.0/relation_detr_resnet50_800_1333_coco_2x.pth",
    "relation_detr_swin_l_800_1333_coco_1x":
        f"{_RD}/v1.0.0/relation_detr_swin_l_800_1333_coco_1x.pth",
    "relation_detr_swin_l_800_1333_coco_2x":
        f"{_RD}/v1.0.0/relation_detr_swin_l_800_1333_coco_2x.pth",
    "relation_detr_resnet50_800_1333_sa_det_100k_1x":
        f"{_RD}/v1.0.0/relation_detr_resnet50_800_1333_sa_det_100k_1x.pth",
    "relation_detr_focalnet_large_lrf_fl4_800_1333_o365_4e":
        f"{_RD}/v1.0.0/relation_detr_focalnet_large_lrf_fl4_800_1333_o365_4e.pth",
    "relation_detr_focalnet_large_lrf_fl4_1200_2000_o365_4e-coco_2x":
        f"{_RD}/v1.0.0/relation_detr_focalnet_large_lrf_fl4_1200_2000_o365_4e-coco_2x.pth",
    "dino++_resnet50_800_1333_coco_1x":
        f"{_RD}/v1.0.1/dino++_resnet50_800_1333_coco_1x.pth",
}

#: arch name → default weight key, the JAX package's table (the ResNets
#: bind torchvision's v2 weights, swin_l the in22k release).
DEFAULT_ARCH_WEIGHTS: Dict[str, str] = {
    "resnet18": "resnet18",
    "resnet34": "resnet34",
    "resnet50": "resnet50_v2",
    "resnet101": "resnet101_v2",
    "resnet152": "resnet152_v2",
    "resnext50_32x4d": "resnext50_32x4d_v2",
    "resnext101_32x4d": "resnext101_32x4d",
    "resnext101_32x8d": "resnext101_32x8d_v2",
    "resnext101_64x4d": "resnext101_64x4d",
    "wide_resnet50_2": "wide_resnet50_2_v2",
    "wide_resnet101_2": "wide_resnet101_2_v2",
    "swin_t": "swin_t",
    "swin_s": "swin_s",
    "swin_b": "swin_b",
    "swin_l": "swin_l_in22k",
    "swin_b_384": "swin_b_384_in22k",
    "swin_l_384": "swin_l_384_in22k",
    "swin_v2_t": "swin_v2_t",
    "swin_v2_s": "swin_v2_s",
    "swin_v2_b": "swin_v2_b",
}


def cache_dirs():
    dirs = []
    env = os.environ.get("RELATION_DETR_WEIGHTS_DIR")
    if env:
        dirs.append(env)
    dirs.append(os.path.expanduser("~/.cache/relation_detr_tpu"))
    return dirs


def lookup_url(name: str) -> Optional[str]:
    """Upstream URL for a registered weight or arch name (None if unknown)."""
    key = DEFAULT_ARCH_WEIGHTS.get(name, name)
    return WEIGHT_URLS.get(key)


def resolve_pretrained(name: str) -> str:
    """Resolve a weight name (or path) to a local converted ``.npz`` file."""
    if os.path.isfile(name):
        return name
    key = DEFAULT_ARCH_WEIGHTS.get(name, name)
    url = WEIGHT_URLS.get(key)
    stems = [key]
    if name != key:
        stems.append(name)
    if url:
        stems.append(os.path.splitext(os.path.basename(url))[0])
    for d in cache_dirs():
        for stem in stems:
            for ext in (".npz", ""):
                cand = os.path.join(d, stem + ext)
                if os.path.isfile(cand):
                    return cand
    if url is None:
        raise KeyError(
            f"unknown pretrained-weight name {name!r}; registered names: "
            + ", ".join(sorted(WEIGHT_URLS)) )
    raise FileNotFoundError(
        f"pretrained weights {name!r} are registered but not cached locally. "
        f"Download {url} on a machine with egress, convert it once with\n"
        f"  python tools/convert_torch_weights.py --torch-checkpoint "
        f"{os.path.basename(url)} --output {key}.npz\n"
        f"and place {key}.npz under $RELATION_DETR_WEIGHTS_DIR or "
        f"~/.cache/relation_detr_tpu/."
    )
