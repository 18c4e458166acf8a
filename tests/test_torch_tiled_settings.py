"""Every MSDA setting of the JAX package in the port (``ops/msda_settings.py``,
``ops/msda_tiled.py``) against the JAX package under the same
``msda_defaults(...)``, forward and VJP, on the same numpy inputs.

The inputs (levels ``SHAPES``, B = 2) sample up to 3 texels off each
token's raster position, and a third of the second image's tokens far
across the image, so that at small halos the clamp and the overflow side
channel engage; one case has capacity K = 1, which overflows. On CPU
tensors the port's kernel wrappers take their plain versions; the JAX
Pallas entries run in interpret mode. fp32 settings at 1e-5 abs, bf16 ones
within 2 bf16 units of the max, the int8 slab against JAX's int8 path at
1e-5.
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from relation_detr_tpu.ops import msda as jmsda
from relation_detr_tpu_torch.ops import msda, msda_settings, msda_tiled

SHAPES = ((13, 17), (7, 9), (4, 5), (2, 3))
HEADS, HEAD_DIM, POINTS = 2, 8, 2
SMALL = dict(tiled_tile_tokens=(4, 4), tiled_halos=(1, 1, 0, 0))  # patches < levels
# the JAX side jitted without LLVM's expensive passes (its Pallas entries in
# interpret mode compile ~5x faster)
QUICK_COMPILE = {"xla_backend_optimization_level": 0, "xla_llvm_disable_expensive_passes": True}


@pytest.fixture(autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _t(x):
    return torch.from_numpy(np.array(x))


def _inputs(seed, bs=2, shapes=SHAPES, num_queries=None):
    """value, locations, weights, cotangent; Q = S in raster order unless
    ``num_queries`` is given (the decoder layout)."""
    rng = np.random.RandomState(seed)
    total = sum(h * w for h, w in shapes)
    value = rng.randn(bs, total, HEADS, HEAD_DIM).astype(np.float32)
    refs = []
    for h, w in shapes:
        ys, xs = (np.arange(h) + 0.5) / h, (np.arange(w) + 0.5) / w
        refs.append(np.stack(np.meshgrid(xs, ys), -1).reshape(-1, 2))
    refs = np.concatenate(refs, 0)
    if num_queries is not None:
        refs = rng.rand(num_queries, 2)
    nq = refs.shape[0]
    norm = np.array([(w, h) for h, w in shapes], np.float32)
    off = rng.uniform(-3.0, 3.0, (bs, nq, HEADS, len(shapes), POINTS, 2))
    locs = (refs[None, :, None, None, None, :] + off / norm[None, None, None, :, None, :])
    locs = locs.astype(np.float32)
    locs[-1, 1::3] = 1.0 - locs[-1, 1::3]
    attn = rng.rand(bs, nq, HEADS, len(shapes), POINTS)
    attn /= attn.reshape(bs, nq, HEADS, -1).sum(-1)[..., None, None]
    cot = rng.randn(bs, nq, HEADS * HEAD_DIM).astype(np.float32)
    return value, locs, attn.astype(np.float32), cot


def _jax_settings(settings):
    out = dict(settings)
    for key in ("tiled_dtype", "gather_dtype"):
        if key in out and out[key] != "auto":
            out[key] = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}[out[key]]
    return out


def _run_both(settings, seed=3, grad=True, shapes=SHAPES, num_queries=None, jax_fn=None):
    value, locs, attn, cot = _inputs(seed, shapes=shapes, num_queries=num_queries)
    jargs = (jnp.asarray(value), jnp.asarray(locs), jnp.asarray(attn))
    fn = jax_fn or (lambda v, l, a: jmsda.multi_scale_deformable_attention(v, shapes, l, a))
    def both(v, l, a, c):
        out, vjp = jax.vjp(fn, v, l, a)
        return out, vjp(c)

    with jmsda.msda_defaults(**_jax_settings(settings)):  # read while tracing
        run = both if grad else (lambda v, l, a, c: (fn(v, l, a), None))
        jargs = jargs + (jnp.asarray(cot),)
        want, jgrads = jax.jit(run).lower(*jargs).compile(QUICK_COMPILE)(*jargs)
        jgrads = [np.asarray(g) for g in jgrads] if grad else None
    targs = [_t(a).requires_grad_(grad) for a in (value, locs, attn)]
    with msda.msda_defaults(**settings):
        got = msda.multi_scale_deformable_attention(targs[0], shapes, targs[1], targs[2])
        if grad:
            got.backward(_t(cot))
    tgrads = [t.grad.numpy() for t in targs] if grad else None
    return got.detach().numpy(), np.asarray(want), tgrads, jgrads


def _close(got, want, tgrads, jgrads, atol=1e-5, grad_rel=1e-4):
    np.testing.assert_allclose(got, want, rtol=0, atol=atol)
    for name, g, w in zip(("value", "locations", "weights"), tgrads or (), jgrads or ()):
        np.testing.assert_allclose(g, w, rtol=0, atol=grad_rel * max(np.abs(w).max(), 1e-30),
                                   err_msg=name)


def _bf16_units(got, want):
    """max |got - want| in bf16 units (ulps) of the max |want|."""
    unit = 2.0 ** (math.floor(math.log2(np.abs(want).max())) - 7)
    return np.abs(got - want).max() / unit


FP32_CASES = {  # settings that the JAX package takes together, merged into one case
    "overflow8_slab_xy": dict(impl="tiled_xla", tiled_overflow=8, tiled_slab_order="xy", **SMALL),
    "overflow1_capacity_slab_bm_batch_unroll": dict(
        impl="tiled_xla", tiled_overflow=1, tiled_slab_order="bm", tiled_batch_unroll=True,
        **SMALL),
    "clamp_only_t_major_tile_margin": dict(impl="tiled_xla", tiled_layout="t_major",
                                           tiled_tile_tokens=(5, 3), tiled_margin=2,
                                           tiled_halos=(0, 0, 0, 0)),
    "entries_overflow_tile_margin": dict(impl="tiled", tiled_tile_tokens=(7, 6), tiled_margin=2,
                                         tiled_halos=(1, 0, 1, 0), tiled_overflow=8),
    "sep_kernel_patch_gather_overflow_auto": dict(impl="tiled_xla", tiled_sep_kernel=True,
                                                  tiled_patch_mode="gather", **SMALL),
    "halos_auto_tiles_slab_auto": dict(impl="tiled_xla", tiled_tile_tokens=(7, 9),
                                       tiled_slab_order="auto"),
}


@pytest.mark.parametrize("name", list(FP32_CASES))
def test_fp32_settings_match_jax(name):
    """Output at 1e-5 abs, the value / location / weight gradients within
    1e-4 of each one's max, against the JAX op under the same settings."""
    before = msda_tiled.tiled_matmul_core.launches, msda_tiled.sep_contract_fused.launches
    _close(*_run_both(FP32_CASES[name]))
    assert (msda_tiled.tiled_matmul_core.launches,
            msda_tiled.sep_contract_fused.launches) == before


def test_overflow_engages_and_is_exact():
    """Where the overflow channel has room the tiled output equals the
    gather's; with K = 1 it does not (entries past capacity clamp), and
    without the channel the clamp shows."""
    value, locs, attn, _ = _inputs(3)
    args = (_t(value), SHAPES, _t(locs), _t(attn))
    gather = msda.msda_reference(*args)
    frac = msda_tiled.tiled_clamp_fraction(SHAPES, args[2], halos=(1, 1, 0, 0),
                                           tile_tokens=(4, 4))
    assert frac > 0.05, frac
    diffs = {}
    for k in (0, 1, 8, 4096):
        with msda.msda_defaults(impl="tiled_xla", tiled_overflow=k, **SMALL):
            diffs[k] = (msda.multi_scale_deformable_attention(*args) - gather).abs().max().item()
    assert diffs[0] > 1e-2 and diffs[1] > 1e-3 and diffs[4096] < 1e-5, diffs


BF16_CASES = {
    "gather_dtype_bf16": dict(impl="gather", gather_dtype=torch.bfloat16),
    "gather_dtype_tiled_dtype_dot_slab_bm": dict(
        impl="tiled_xla", gather_dtype=torch.bfloat16, tiled_dtype=torch.bfloat16,
        tiled_dot_bf16=True, tiled_slab_order="bm", **SMALL),
    "dot_bf16_t_major": dict(impl="tiled_xla", tiled_dot_bf16=True, tiled_layout="t_major",
                             **SMALL),
    "bf16_t_major": dict(impl="tiled_xla", tiled_dtype=torch.bfloat16, tiled_layout="t_major",
                         tiled_overflow=0),
    "bf16_sep_kernel": dict(impl="tiled_xla", tiled_dtype=torch.bfloat16,
                            tiled_sep_kernel=True, **SMALL),
    "bf16_entries": dict(impl="tiled", tiled_dtype=torch.bfloat16, tiled_tile_tokens=(7, 6),
                         tiled_halos=(1, 1, 0, 0)),
}


@pytest.mark.parametrize("name", list(BF16_CASES))
def test_bf16_settings_match_jax(name):
    """The output within 2 bf16 units of its max of JAX's, each gradient
    within 2 bf16 units of its max (JAX adds a bf16 value's gradient in
    bf16, the port in fp32, rounded once). The entries route's case holds
    the forward only: its VJP is the fp32 case's with the slab's casts,
    which the separable cases' VJPs hold (JAX's interpret-mode backward
    kernel alone takes ~15 s to compile)."""
    got, want, tgrads, jgrads = _run_both(BF16_CASES[name], grad=name != "bf16_entries")
    assert _bf16_units(got, want) <= 2.0, _bf16_units(got, want)
    for label, g, w in zip(("value", "locations", "weights"), tgrads or (), jgrads or ()):
        assert _bf16_units(g, w) <= 2.0, (label, _bf16_units(g, w))


@pytest.mark.parametrize("order", ["yx", "bm"])
def test_int8_slab_matches_jax(order):
    """tiled_int8_slab (eval only): the per-channel absmax over (B, h, w),
    round half to even, clip to 127, dequantised on the contraction output,
    against JAX's int8 path at 1e-5; the quantisation moves the output."""
    settings = dict(impl="tiled_xla", tiled_int8_slab=True, tiled_slab_order=order,
                    tiled_overflow=0, **SMALL)
    got, want, _, _ = _run_both(settings, grad=False)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    exact, _, _, _ = _run_both(dict(settings, tiled_int8_slab=False), grad=False)
    assert np.abs(got - exact).max() > 1e-4


@pytest.mark.parametrize("impl,jax_fn,layout", [
    ("corner_pack", jmsda._msda_corner_pack, "encoder"),
    ("pair", jmsda._msda_pair_gather, "decoder"),
    ("auto", jmsda._msda_corner_pack, "decoder"),
    ("auto_pallas", jmsda._msda_corner_pack, "encoder"),
], ids=["corner_pack-encoder", "pair-decoder", "auto-decoder", "auto_pallas-encoder"])
def test_gather_serves_the_other_impls(impl, jax_fn, layout):
    """corner_pack and pair, and the auto impls (corner_pack off a TPU),
    are served by the gather, whose output and gradients equal theirs:
    against JAX's ``_msda_corner_pack`` / ``_msda_pair_gather``, with
    ``dense_level_rows`` and ``decoder_prepack`` set (they steer only
    corner_pack) and the one-hot route of small levels taken."""
    settings = dict(impl=impl, dense_level_rows=40, decoder_prepack=False)
    nq = None if layout == "encoder" else 37

    def fn(v, l, a):
        return jax_fn(v, SHAPES, l, a, jnp.float32)

    _close(*_run_both(settings, num_queries=nq, jax_fn=fn))


@pytest.mark.parametrize("case", [
    dict(), dict(halos=(1, 1, 0, 0), tile_tokens=(4, 4)), dict(halos=(0, 0, 0, 0), margin=2),
    dict(halos=(1, 0, 1, 0), tile_tokens=(5, 3), weights=False),
], ids=["auto", "small", "zero_margin2", "unweighted"])
def test_tiled_clamp_fraction_matches_jax(case):
    """``tiled_clamp_fraction`` equal to JAX's at 1e-7, under the defaults
    or the given geometry, attention-weighted or not."""
    case = dict(case)
    weighted = case.pop("weights", True)
    _, locs, attn, _ = _inputs(5)
    want = float(jmsda.tiled_clamp_fraction(SHAPES, jnp.asarray(locs),
                                            jnp.asarray(attn) if weighted else None, **case))
    got = float(msda_tiled.tiled_clamp_fraction(SHAPES, _t(locs),
                                                _t(attn) if weighted else None, **case))
    assert abs(got - want) <= 1e-7, (got, want)
    if case:
        assert got > 0.0


def test_settings_take_every_jax_keyword():
    """set_msda_defaults / msda_defaults take the JAX package's 16 keywords
    with its defaults (impl aside: the port's is the gather); the
    defaults come back after the context; an unknown value raises."""
    import inspect

    jax_keys = list(inspect.signature(jmsda.set_msda_defaults).parameters)
    assert list(inspect.signature(msda.set_msda_defaults).parameters) == jax_keys
    assert set(msda._MSDA_DEFAULTS) == set(jmsda._MSDA_DEFAULTS) == set(jax_keys)
    for key, value in jmsda._MSDA_DEFAULTS.items():
        if key not in ("impl", "gather_dtype"):
            assert msda._MSDA_DEFAULTS[key] == value, key
    saved = dict(msda._MSDA_DEFAULTS)
    everything = dict(impl="tiled", gather_dtype=torch.bfloat16, tiled_dtype=torch.bfloat16,
                      tiled_halos=[2, 2, 1, 1], tiled_tile_tokens=[24, 8], tiled_margin=2,
                      dense_level_rows=100, tiled_layout="t_major", decoder_prepack=False,
                      tiled_overflow=4, tiled_patch_mode="gather", tiled_sep_kernel=True,
                      tiled_dot_bf16="auto", tiled_slab_order="bm", tiled_batch_unroll=True,
                      tiled_int8_slab=True)
    with msda.msda_defaults(**everything):
        assert msda._MSDA_DEFAULTS["tiled_halos"] == (2, 2, 1, 1)
        assert msda._MSDA_DEFAULTS["tiled_tile_tokens"] == (24, 8)
        assert not msda_settings.dot_bf16_enabled()
        assert msda_settings.resolve_tiled_dtype() == torch.bfloat16
    assert msda._MSDA_DEFAULTS == saved
    assert msda_settings.resolve_tiled_dtype() == torch.float32
    for bad in (dict(impl="tiles"), dict(tiled_slab_order="zz"), dict(tiled_layout="t"),
                dict(tiled_patch_mode="rows"), dict(tiled_dtype=torch.float16)):
        with pytest.raises(ValueError):
            msda.set_msda_defaults(**bad)
    assert msda._MSDA_DEFAULTS == saved


LEVELS_800 = ((100, 168), (50, 84), (25, 42), (13, 21))
LEVELS_1216 = ((152, 252), (76, 126), (38, 63), (19, 32))
KERNEL_GRID = [(tiles, "auto", 1) for tiles in
               ((10, 8), (12, 8), (12, 10), (14, 8), (16, 8), (24, 8))] + [
    ((12, 8), "auto", 2), ((12, 8), (4, 3, 2, 2), 1), ((12, 8), (0, 0, 0, 0), 1),
    ((12, 8), (8, 8, 8, 8), 1)]


@pytest.mark.parametrize("levels", [LEVELS_800, LEVELS_1216], ids=["800x1344", "1216x2016"])
def test_kernel_limits_take_the_settings_grid(levels):
    """The Python mirrors of the three tiled kernels' limits (shared memory
    of tiled_core_fwd / tiled_core_bwd with their one-stage forms, and
    sep_contract_fwd's width and shared memory) accept every geometry of
    the JAX package's documented settings on both canvases (H = 8, D = 32,
    P = 4), and a geometry beyond them raises, naming the limit."""
    limit = msda_tiled._MAX_SMEM
    for tiles, halos, margin in KERNEL_GRID:
        geo, _, _ = msda_tiled.tiled_geometry(levels, 4, tiles, halos, margin)
        for _, _, ph, pw in geo.patches:
            rows = ph * pw
            assert msda_tiled._fwd_smem_bytes(rows, 32, 16, geo.T) <= limit
            assert msda_tiled._bwd_smem_bytes(rows, 32, 16, geo.T) <= limit
            assert pw <= msda_tiled._SEP_MAX_PW
            assert (rows * 32 + msda_tiled._SEP_A_FLOATS) * 4 <= limit
    geo, _, _ = msda_tiled.tiled_geometry(levels, 4, (24, 8), (8, 8, 8, 8), 1)
    _, _, ph, pw = geo.patches[0]
    assert msda_tiled._bwd_smem_bytes(ph * pw, 32, 16, geo.T) > limit
    m = torch.zeros(1, 1, 8, 16, geo.T, dtype=torch.int32)
    with pytest.raises(ValueError, match=str(limit)):
        msda_tiled._check_core_args(m, m.float(), torch.zeros(1, 1, ph * pw, 256), (8, 32),
                                    g=torch.zeros(1, 1, geo.T, 256))
