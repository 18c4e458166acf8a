"""Framework-wide MSDA settings: the counterpart of the JAX package's
``_MSDA_DEFAULTS``, ``set_msda_defaults``, ``msda_defaults`` and
``apply_msda_cli_flags`` (``relation_detr_tpu/ops/msda.py:43-278``), with
the same 16 keywords and defaults, except ``impl``, whose port default is
"gather" (one hand-written kernel, exact at any location).

What each setting does in the port:

- ``impl``: "gather" (``csrc/msda.cu``); "tiled" / "tiled_xla" send an
  encoder-layout call (Q == S) to ``ops/msda_tiled.py``; "pair",
  "corner_pack", "auto", "auto_xla" and "auto_pallas" go to the gather. Off a
  TPU the JAX package sends the auto impls to corner_pack
  (``relation_detr_tpu/ops/msda.py:401-417``), and corner_pack and pair
  compute the gather's output exactly; the card is not a TPU.
- ``gather_dtype``: the dtype the value is sampled in (torch.float32 or
  torch.bfloat16); a bf16 gather_dtype rounds the value to bf16, which is
  then sampled in fp32.
- ``dense_level_rows`` and ``decoder_prepack`` steer only the JAX
  package's corner_pack, whose output the gather equals; they are kept and
  change nothing here.
- the ``tiled_*`` settings steer ``ops/msda_tiled.py`` as they steer
  ``_msda_tiled``. ``tiled_dtype="auto"`` and ``tiled_dot_bf16="auto"``
  resolve as the JAX package resolves them off a TPU: fp32, and off.
"""
from __future__ import annotations

import contextlib

import torch

from relation_detr_tpu_torch.ops.tile_geometry import MARGIN, TILE_TOKENS

_MSDA_DEFAULTS = {
    "impl": "gather",
    "gather_dtype": torch.float32,
    "tiled_dtype": "auto",
    "tiled_halos": "auto",
    "tiled_tile_tokens": TILE_TOKENS,
    "tiled_margin": MARGIN,
    "dense_level_rows": 1536,
    "decoder_prepack": True,
    "tiled_overflow": "auto",
    "tiled_patch_mode": "slices",
    "tiled_slab_order": "yx",
    "tiled_batch_unroll": False,
    "tiled_layout": "t_minor",
    "tiled_sep_kernel": False,
    "tiled_dot_bf16": False,
    "tiled_int8_slab": False,
}
IMPLS = ("gather", "tiled", "tiled_xla", "pair", "corner_pack", "auto", "auto_xla",
         "auto_pallas")
_DTYPES = (torch.float32, torch.bfloat16)


def _choice(name, value, allowed):
    if value not in allowed:
        raise ValueError(f"MSDA setting {name}={value!r}: one of {allowed}")
    return value


def _dtype(name, value, auto):
    if (auto and value == "auto") or value in _DTYPES:
        return value
    raise ValueError(f"MSDA setting {name}={value!r}: torch.float32 or torch.bfloat16"
                     + (' or "auto"' if auto else ""))


def set_msda_defaults(impl: str = None, gather_dtype=None, tiled_dtype=None,
                      tiled_halos=None, tiled_tile_tokens=None,
                      tiled_margin=None, dense_level_rows=None,
                      tiled_layout=None, decoder_prepack=None,
                      tiled_overflow=None, tiled_patch_mode=None,
                      tiled_sep_kernel=None, tiled_dot_bf16=None,
                      tiled_slab_order=None,
                      tiled_batch_unroll=None, tiled_int8_slab=None) -> None:
    """The JAX package's ``set_msda_defaults``: each keyword given sets its
    setting for every later call; a value the JAX package does not take
    raises ``ValueError``."""
    d = _MSDA_DEFAULTS
    if tiled_int8_slab is not None:
        d["tiled_int8_slab"] = bool(tiled_int8_slab)
    if tiled_slab_order is not None:
        d["tiled_slab_order"] = _choice("tiled_slab_order", tiled_slab_order,
                                        ("auto", "yx", "xy", "bm"))
    if tiled_batch_unroll is not None:
        d["tiled_batch_unroll"] = bool(tiled_batch_unroll)
    if tiled_dot_bf16 is not None:
        d["tiled_dot_bf16"] = "auto" if tiled_dot_bf16 == "auto" else bool(tiled_dot_bf16)
    if tiled_sep_kernel is not None:
        d["tiled_sep_kernel"] = bool(tiled_sep_kernel)
    if tiled_patch_mode is not None:
        d["tiled_patch_mode"] = _choice("tiled_patch_mode", tiled_patch_mode,
                                        ("slices", "gather"))
    if decoder_prepack is not None:
        d["decoder_prepack"] = bool(decoder_prepack)
    if tiled_overflow is not None:
        d["tiled_overflow"] = "auto" if tiled_overflow == "auto" else int(tiled_overflow)
    if impl is not None:
        d["impl"] = _choice("impl", impl, IMPLS)
    if gather_dtype is not None:
        d["gather_dtype"] = _dtype("gather_dtype", gather_dtype, auto=False)
    if tiled_dtype is not None:
        d["tiled_dtype"] = _dtype("tiled_dtype", tiled_dtype, auto=True)
    if tiled_halos is not None:
        d["tiled_halos"] = "auto" if tiled_halos == "auto" else tuple(
            int(v) for v in tiled_halos)
    if tiled_tile_tokens is not None:
        d["tiled_tile_tokens"] = tuple(int(v) for v in tiled_tile_tokens)
    if tiled_margin is not None:
        d["tiled_margin"] = int(tiled_margin)
    if dense_level_rows is not None:
        d["dense_level_rows"] = int(dense_level_rows)
    if tiled_layout is not None:
        d["tiled_layout"] = _choice("tiled_layout", tiled_layout, ("t_minor", "t_major"))


@contextlib.contextmanager
def msda_defaults(impl: str = None, gather_dtype=None, tiled_dtype=None,
                  tiled_halos=None, tiled_tile_tokens=None, tiled_margin=None,
                  dense_level_rows=None, tiled_layout=None,
                  decoder_prepack=None, tiled_overflow=None,
                  tiled_patch_mode=None, tiled_sep_kernel=None,
                  tiled_dot_bf16=None,
                  tiled_slab_order=None, tiled_batch_unroll=None,
                  tiled_int8_slab=None):
    """``set_msda_defaults`` for the duration of a ``with`` block."""
    saved = dict(_MSDA_DEFAULTS)
    try:
        set_msda_defaults(impl, gather_dtype, tiled_dtype, tiled_halos,
                          tiled_tile_tokens, tiled_margin, dense_level_rows,
                          tiled_layout, decoder_prepack, tiled_overflow,
                          tiled_patch_mode, tiled_sep_kernel, tiled_dot_bf16,
                          tiled_slab_order, tiled_batch_unroll, tiled_int8_slab)
        yield
    finally:
        _MSDA_DEFAULTS.clear()
        _MSDA_DEFAULTS.update(saved)


def apply_msda_cli_flags(args) -> None:
    """The shared --msda-impl / --msda-halos / --msda-dtype /
    --msda-int8-slab flags onto the defaults, as the JAX package's
    ``apply_msda_cli_flags``."""
    if getattr(args, "msda_impl", None):
        set_msda_defaults(impl=args.msda_impl)
    if getattr(args, "msda_halos", None):
        set_msda_defaults(tiled_halos="auto" if args.msda_halos == "auto"
                          else tuple(int(v) for v in args.msda_halos.split(",")))
    if getattr(args, "msda_dtype", None):
        set_msda_defaults(tiled_dtype={"fp32": torch.float32, "bf16": torch.bfloat16,
                                       "auto": "auto"}[args.msda_dtype])
    if getattr(args, "msda_int8_slab", False):
        set_msda_defaults(tiled_int8_slab=True)


def resolve_tiled_dtype() -> torch.dtype:
    """``tiled_dtype``, "auto" resolved as off a TPU: fp32."""
    d = _MSDA_DEFAULTS["tiled_dtype"]
    return torch.float32 if d == "auto" else d


def dot_bf16_enabled() -> bool:
    """``tiled_dot_bf16``, "auto" resolved as off a TPU: off."""
    flag = _MSDA_DEFAULTS["tiled_dot_bf16"]
    return False if flag == "auto" else bool(flag)
