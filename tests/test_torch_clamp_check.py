"""The port's clamp gate (``utils/clamp_check.py``) against the JAX package's
(``relation_detr_tpu/utils/clamp_check.py``): the four cases of
tests/test_clamp_check.py on the tiny config, the port's seeded weights
carried to the JAX model by ``convert_state_dict``, and each encoder layer's
fraction against the one JAX measures on its own captured forward.

The two models' sampling locations agree to float rounding, so a corner on
a texel boundary may fall on either side: the per-layer fractions are held
at 1e-4 (a flipped corner moves a fraction by its weight's share, ~1e-6
here), the fractions of the same locations at 1e-7.
"""
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, ".")
from tools.convert_torch_weights import convert_state_dict  # noqa: E402

from relation_detr_tpu.models.detector import RelationDETR as JRelationDETR  # noqa: E402
from relation_detr_tpu.ops import msda as jmsda  # noqa: E402
from relation_detr_tpu.utils import clamp_check as jclamp  # noqa: E402
from relation_detr_tpu_torch.ops import msda  # noqa: E402
from relation_detr_tpu_torch.utils import clamp_check  # noqa: E402
from relation_detr_tpu_torch.utils.config import Config  # noqa: E402
from tests.test_torch_modules import unflatten  # noqa: E402

TINY = "relation_detr_tpu_torch/configs/relation_detr/relation_detr_resnet50_tiny_test.py"
QUICK_COMPILE = {"xla_backend_optimization_level": 0, "xla_llvm_disable_expensive_passes": True}
TOL_LAYER = 1e-4


def _jax_fractions(jmodel, variables, images, mask, halos):
    """JAX's per-layer fractions (in call order) of one jitted captured
    forward, scored by its ``fractions_for``."""
    def capture(v, x, m):
        return jmodel.apply(v, x, m, train=False, mutable=["intermediates"])[1]

    args = (variables, jnp.asarray(images), jnp.asarray(mask))
    state = jax.jit(capture).lower(*args).compile(QUICK_COMPILE)(*args)
    shapes = jclamp._encoder_spatial_shapes(images.shape[1], images.shape[2])
    total = sum(h * w for h, w in shapes)
    captured = [c for c in jclamp._iter_sampling(state.get("intermediates", {}))
                if c[1].shape[1] == total]
    return {h: list(jclamp.fractions_for(shapes, captured, halos=h).values()) for h in halos}


def _shrink_offsets(model):
    """The sampling offsets' biases x 0.05: every sample near its reference."""
    with torch.no_grad():
        for name, p in model.named_parameters():
            if "sampling_offsets" in name and name.endswith("bias"):
                p.mul_(0.05)


@pytest.fixture(scope="module")
def tiny():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    model = Config(TINY).build_model(device="cpu", seed=0)
    jmodel = JRelationDETR(**Config(TINY).model_args)

    def variables(m):
        params, stats, leftover = convert_state_dict(dict(m.state_dict()))
        assert not leftover, leftover[:8]
        return {"params": unflatten(params), "batch_stats": unflatten(stats)}

    rng = np.random.RandomState(0)
    small = rng.rand(1, 128, 160, 3).astype(np.float32)
    large = rng.rand(1, 256, 320, 3).astype(np.float32)
    shrunk = Config(TINY).build_model(device="cpu", seed=0)
    _shrink_offsets(shrunk)
    want = {
        "small": _jax_fractions(jmodel, variables(model), small, np.zeros((1, 128, 160), bool),
                                ("auto", (0, 0, 0, 0))),
        "large": _jax_fractions(jmodel, variables(model), large, np.zeros((1, 256, 320), bool),
                                (clamp_check.FAST_HALOS,)),
    }
    yield dict(model=model, shrunk=shrunk, small=small, large=large, want=want)
    torch.set_num_threads(threads)


def _mask(images):
    return np.zeros(images.shape[:3], bool)


def test_init_checkpoint_is_exact_at_auto_halos(tiny):
    """Provably exact at the radial offset init under auto halos: every
    encoder layer's fraction 0, as JAX's."""
    fracs = clamp_check.measure_clamp_fractions(tiny["model"], tiny["small"],
                                                _mask(tiny["small"]))
    assert fracs, "no encoder MSDA layer captured"
    assert max(fracs.values()) == 0.0
    assert list(fracs.values()) == tiny["want"]["small"]["auto"]


def test_forced_clamping_halos_fail_loudly(tiny):
    """Halos 0 without overflow: a forced setting raises, an unforced one
    warns and returns the worst fraction; per layer as JAX's. A uint8
    canvas is normalised first (the eval CLI's upload)."""
    model, images = tiny["model"], tiny["small"]
    with msda.msda_defaults(tiled_halos=(0, 0, 0, 0), tiled_overflow=0):
        with pytest.raises(RuntimeError, match="border-clamp"):
            clamp_check.check_checkpoint_clamp(model, images, _mask(images), threshold=1e-3,
                                               halos_forced=True, force=True)
        found = clamp_check.check_checkpoint_clamp(model, images, _mask(images),
                                                   threshold=1e-3, force=True)
        assert found is not None and found["worst"] > 1e-3
        got = list(found["fractions"].values())
        raw = (images * 255).astype(np.uint8)
        found_u8 = clamp_check.check_checkpoint_clamp(model, raw, _mask(raw), force=True)
        assert found_u8 is not None and found_u8["worst"] > 1e-3
    np.testing.assert_allclose(got, tiny["want"]["small"][(0, 0, 0, 0)], rtol=0, atol=TOL_LAYER)


def test_gate_skips_when_tiled_route_off(tiny):
    """The gate measures under a tiled impl; under the gather, corner_pack
    and the auto impls (the gather on this backend, as corner_pack in JAX
    off a TPU) it returns None unless forced, as JAX's does on its CPU."""
    model, images = tiny["model"], tiny["small"]
    for impl in ("gather", "corner_pack", "auto", "auto_xla", "auto_pallas", "pair"):
        with msda.msda_defaults(impl=impl):
            assert clamp_check.check_checkpoint_clamp(model, images, _mask(images)) is None
            assert clamp_check.check_and_select_profile(model, images, _mask(images)) is None
        if impl != "gather":
            with jmsda.msda_defaults(impl=impl):  # JAX's skips return before the forward
                assert jclamp.check_checkpoint_clamp(None, None, images, _mask(images)) is None
    with msda.msda_defaults(impl="tiled_xla"):
        assert clamp_check.check_checkpoint_clamp(model, images, _mask(images))["worst"] == 0.0


def test_profile_auto_selection(tiny):
    """At the offset init the fast halos clamp, so the profile stays exact;
    with shrunken offsets the fast halos are measured safe and selected
    (halos FAST_HALOS, overflow 0), restored after the context; at the
    init the fast halos' per-layer fractions as JAX's."""
    images = tiny["large"]
    with msda.msda_defaults():
        sel = clamp_check.check_and_select_profile(tiny["model"], images, _mask(images),
                                                   force=True, allow_fast=True)
        assert sel["profile"] == "exact" and msda._MSDA_DEFAULTS["tiled_halos"] == "auto"
        fast = sel["fast_worst"]
    assert fast > 1e-6
    assert abs(fast - max(tiny["want"]["large"][clamp_check.FAST_HALOS])) <= TOL_LAYER
    with msda.msda_defaults():
        sel = clamp_check.check_and_select_profile(tiny["shrunk"], images, _mask(images),
                                                   force=True, allow_fast=True)
        assert sel["profile"] == "fast"
        assert msda._MSDA_DEFAULTS["tiled_halos"] == clamp_check.FAST_HALOS
        assert msda._MSDA_DEFAULTS["tiled_overflow"] == 0
        fast = sel["fast_worst"]
    assert msda._MSDA_DEFAULTS["tiled_halos"] == "auto"
    assert fast == 0.0  # JAX's test_profile_auto_selection selects "fast" here too


def test_fractions_of_the_same_locations_match_jax(tiny):
    """The port's captured locations scored by both packages'
    ``fractions_for`` at several halos: equal at 1e-7."""
    shapes, captured = clamp_check.capture_sampling(tiny["model"], tiny["large"],
                                                    _mask(tiny["large"]))
    jcaptured = [(p, jnp.asarray(l.numpy()), jnp.asarray(a.numpy())) for p, l, a in captured]
    for halos in (None, clamp_check.FAST_HALOS, (1, 1, 1, 1), (0, 0, 0, 0)):
        got = list(clamp_check.fractions_for(shapes, captured, halos=halos).values())
        want = list(jclamp.fractions_for(shapes, jcaptured, halos=halos).values())
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-7)
