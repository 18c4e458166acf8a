"""The tiled MSDA's clamp gate: a checkpoint's clamp fraction, measured at
load time on its own sampling locations.

Counterpart of ``relation_detr_tpu/utils/clamp_check.py``. The tiled
encoder forms (``ops/msda_tiled.py``) are exact while every sampled corner
lies in its tile's halo'd patch; beyond it a corner goes through the
overflow side channel (up to its capacity) or reads the patch border. A
trained checkpoint's offsets can pass any fixed halo, so one captured eval
forward (``models/attention.py::record_sampling``, in place of flax's
``sow``) keeps every MSDA layer's (locations, weights), and
``tiled_clamp_fraction`` scores the encoder layers (queries == raster
tokens) against the halos that will run.

The gate measures under a tiled impl ("tiled", "tiled_xla"). The auto impls
go to the gather on the card, as they go to corner_pack in the JAX package
off a TPU, so there it returns None unless ``force`` is set; under the
gather and the other impls it returns None unless ``force``.
"""
from __future__ import annotations

import logging
from typing import Dict, Optional

import torch

from relation_detr_tpu_torch.data.loader import Normalizer
from relation_detr_tpu_torch.models.attention import record_sampling
from relation_detr_tpu_torch.ops.msda_settings import _MSDA_DEFAULTS, set_msda_defaults
from relation_detr_tpu_torch.ops.msda_tiled import tiled_clamp_fraction

logger = logging.getLogger("relation_detr_tpu_torch")

FAST_HALOS = (4, 3, 2, 2)


def gate_active(force: bool = False) -> bool:
    """Whether the gate measures under the current impl: the JAX package's
    skip rules, with the card (or the CPU) as a backend that is not a TPU."""
    return force or _MSDA_DEFAULTS["impl"] in ("tiled", "tiled_xla")


def capture_sampling(model: torch.nn.Module, images, mask):
    """One captured eval forward of ``model`` (weights where they lie):
    returns (spatial_shapes, [(path, locations, weights)] for the encoder
    MSDA layers, in call order): the calls whose queries are the raster
    tokens of their own levels. A uint8 canvas is normalised as
    ``utils/evaluation.py::make_detections_fn`` normalises it."""
    device = next(model.parameters()).device
    images = torch.as_tensor(images, device=device)
    mask = torch.as_tensor(mask, dtype=torch.bool, device=device)
    if images.dtype == torch.uint8:
        images = Normalizer(device)(images, mask)
    names = {id(m): name for name, m in model.named_modules()}
    training = model.training
    model.eval()
    try:
        with torch.inference_mode(), record_sampling() as records:
            model(images.float(), mask)
    finally:
        model.train(training)
    # the decoder samples anywhere, by the gather
    encoder = [r for r in records if r[1].shape[1] == sum(h * w for h, w in r[3])]
    shapes = encoder[0][3] if encoder else ()
    return shapes, [(names[id(module)], locs, attn) for module, locs, attn, _ in encoder]


def fractions_for(shapes, captured, halos=None) -> Dict[str, float]:
    return {path: float(tiled_clamp_fraction(shapes, locs, attn, halos=halos))
            for path, locs, attn in captured}


def measure_clamp_fractions(model, images, mask, halos=None) -> Dict[str, float]:
    """One captured eval forward; the encoder layers' attention-weighted
    clamp fractions by module path, each in [0, 1]."""
    shapes, captured = capture_sampling(model, images, mask)
    return fractions_for(shapes, captured, halos=halos)


def _clamp_message(worst, halos):
    return (f"tiled MSDA would border-clamp {worst:.2%} (attention-weighted) of this "
            f"checkpoint's sampling corners at halos={halos}. Use --msda-halos auto (or "
            "larger per-level radii), or raise the overflow capacity "
            "(ops.msda.set_msda_defaults(tiled_overflow=N)).")


def _measure(model, images, mask, threshold, halos_forced, force):
    """The gate's core: one captured forward scored at the active halos,
    logged; raises when the user forced halos that clamp past
    ``threshold``, else warns. Returns (measurement, shapes, captured), the
    measurement {"fractions": per encoder layer, "worst"}, or None when the
    gate does not measure."""
    if not gate_active(force):
        return None
    shapes, captured = capture_sampling(model, images, mask)
    if not captured:
        return None
    fracs = fractions_for(shapes, captured)
    worst = max(fracs.values())
    halos = _MSDA_DEFAULTS["tiled_halos"]
    logger.info(
        "tiled MSDA clamp fraction for this checkpoint (halos=%s, overflow=%s): max %.2e "
        "over %d encoder layers%s", halos, _MSDA_DEFAULTS["tiled_overflow"], worst, len(fracs),
        "" if worst == 0.0 else " — nonzero fractions: "
        + ", ".join(f"{p}={v:.2e}" for p, v in fracs.items() if v > 0))
    if worst > threshold:
        if halos_forced:
            raise RuntimeError(_clamp_message(worst, halos))
        logger.warning(_clamp_message(worst, halos))
    return {"fractions": fracs, "worst": worst}, shapes, captured


def check_checkpoint_clamp(model, images, mask, threshold: float = 1e-3,
                           halos_forced: bool = False, force: bool = False) -> Optional[Dict]:
    """Measure and log the checkpoint's tiled clamp fraction; raise when
    the user forced clamping halos past ``threshold``, else warn. Returns
    {"fractions": per encoder layer, "worst": the largest}, or None when
    the gate does not measure."""
    found = _measure(model, images, mask, threshold, halos_forced, force)
    return None if found is None else found[0]


def check_and_select_profile(model, images, mask, threshold: float = 1e-3,
                             fast_threshold: float = 1e-6, halos_forced: bool = False,
                             allow_fast: bool = True, force: bool = False) -> Optional[Dict]:
    """One captured forward: report the clamp fraction at the active halos
    (raising as ``check_checkpoint_clamp`` does) and, when ``allow_fast``
    and the halos were not forced, switch the defaults to halos
    ``FAST_HALOS`` with no overflow channel where the checkpoint's
    fraction at those halos is at most ``fast_threshold``. Returns
    ``check_checkpoint_clamp``'s measurement with "profile" ("fast" or
    "exact") and, where measured, "fast_worst"; or None when the gate does
    not measure."""
    found = _measure(model, images, mask, threshold, halos_forced, force)
    if found is None:
        return None
    measurement, shapes, captured = found
    measurement["profile"] = "exact"
    if allow_fast and not halos_forced:
        fast_worst = max(fractions_for(shapes, captured, halos=FAST_HALOS).values())
        measurement["fast_worst"] = fast_worst
        if fast_worst <= fast_threshold:
            set_msda_defaults(tiled_halos=FAST_HALOS, tiled_overflow=0)
            logger.info("fast MSDA profile auto-selected: this checkpoint's measured sampling "
                        "corners all fall within halos %s (attention-weighted fraction %.1e "
                        "<= %.0e); strays on unmeasured images border-clamp. Force "
                        "--msda-profile exact to disable.", FAST_HALOS, fast_worst,
                        fast_threshold)
            measurement["profile"] = "fast"
        else:
            logger.info("staying on exact halos: fast-profile clamp fraction %.2e > %.0e",
                        fast_worst, fast_threshold)
    return measurement
