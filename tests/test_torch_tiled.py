"""The port's tiled encoder MSDA (``ops/msda_tiled.py``) and relation
versions 1/2 against the JAX package on the same numpy inputs.

On CPU tensors the port's kernel wrappers take their plain versions; the
JAX Pallas kernels (``tiled_matmul_core``, ``sep_contract_fused``,
``fused_relation_bias``, ``window_accumulate``) run in interpret mode.
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
from relation_detr_tpu.ops import relation_pallas as jrel  # noqa: E402
from relation_detr_tpu.ops.msda_pallas import tiled_matmul_core as j_tiled_core  # noqa: E402
from relation_detr_tpu.ops.msda_sep_pallas import sep_contract_fused as j_sep  # noqa: E402
from relation_detr_tpu_torch.models.detector import RelationDETR  # noqa: E402
from relation_detr_tpu_torch.ops import msda, msda_tiled, patch_scatter  # noqa: E402
from relation_detr_tpu_torch.ops import relation_bias as trel  # noqa: E402
from relation_detr_tpu_torch.ops.tile_geometry import _TileGeometry  # noqa: E402
from tests.test_torch_modules import perturb, unflatten  # noqa: E402

SHAPES = ((13, 17), (7, 9), (4, 5), (2, 3))


def _t(x):
    return torch.from_numpy(np.array(x))


def _launches():
    return (msda_tiled.tiled_matmul_core.launches, msda_tiled.tiled_core_backward.launches,
            msda_tiled.sep_contract_fused.launches, patch_scatter.window_accumulate.launches,
            msda.multi_scale_deformable_attention.launches, trel.fused_relation_bias.launches)


@pytest.mark.parametrize("case", [
    (((100, 168), (50, 84), (25, 42), (13, 21)), (12, 8), (5,) * 4, 1),  # flagship
    (((32, 40), (16, 20), (8, 10), (4, 5)), (12, 8), (5,) * 4, 1),  # tiny config 256x320
    (((11, 13), (6, 7), (3, 4)), (4, 4), (2, 1), 2),  # other tiles, halos, margin
])
def test_tile_geometry_matches_jax(case):
    """perm, inv, slot_valid, patches, T, M: exact."""
    got, want = _TileGeometry(*case), jmsda._TileGeometry(*case)
    for name in ("grid", "ntiles", "T", "M", "patch_grid"):
        assert getattr(got, name) == getattr(want, name), name
    for name in ("perm", "inv", "slot_valid"):
        np.testing.assert_array_equal(getattr(got, name), getattr(want, name), err_msg=name)
        assert getattr(got, name).dtype == getattr(want, name).dtype, name
    for g, w in zip(got.patches, want.patches):
        np.testing.assert_array_equal(g[0], w[0])
        np.testing.assert_array_equal(g[1], w[1])
        assert g[2:] == w[2:]
    if case[0][0] == (100, 168):  # patch_scatter's level-0 constants come from here
        assert patch_scatter.LEVEL0_WINDOW == (23, 19) and got.T == 128 and got.ntiles == 189
        assert [ph * pw for _, _, ph, pw in got.patches] == [437, 255, 182, 156]


def _core_inputs(seed, bs=2, nt=3, heads=2, head_dim=8, entries=16, t=16, ph=5, pw=4,
                 points=4):
    rng = np.random.RandomState(seed)
    m = rng.randint(-2, ph * pw + 2, (bs, nt, heads, entries, t)).astype(np.int32)
    w = rng.randn(bs, nt, heads, entries, t).astype(np.float32)
    patch = rng.randn(bs, nt, ph * pw, heads * head_dim).astype(np.float32)
    oy = rng.rand(bs, nt, heads, points, ph, t).astype(np.float32)
    ox = rng.rand(bs, nt, heads, points, pw, t).astype(np.float32)
    g = rng.randn(bs, nt, t, heads * head_dim).astype(np.float32)
    return dict(m=m, w=w, patch=patch, oy=oy, ox=ox, g=g, dims=(heads, head_dim))


@pytest.mark.parametrize("op", ["tiled_matmul_core", "sep_contract_fused"])
def test_core_plain_versions_match_jax_kernels(op):
    """The plain versions of the two contraction kernels against the JAX
    entries (Pallas interpret mode), forward and VJP, 1e-5 abs; entries
    with a patch row outside [0, M) add nothing on either side."""
    x = _core_inputs(1)
    before = _launches()
    if op == "tiled_matmul_core":
        jargs = (jnp.asarray(x["m"]), jnp.asarray(x["w"]), jnp.asarray(x["patch"]))
        want, vjp = jax.vjp(lambda w, p: j_tiled_core(jargs[0], w, p, x["dims"]), *jargs[1:])
        targs = [_t(x["w"]).requires_grad_(True), _t(x["patch"]).requires_grad_(True)]
        got = msda_tiled.tiled_matmul_core(_t(x["m"]), *targs, x["dims"])
    else:
        jargs = (jnp.asarray(x["oy"]), jnp.asarray(x["ox"]), jnp.asarray(x["patch"]))
        want, vjp = jax.vjp(j_sep, *jargs)
        targs = [_t(x[k]).requires_grad_(True) for k in ("oy", "ox", "patch")]
        got = msda_tiled.sep_contract_fused(*targs)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=0, atol=1e-5)
    got.backward(_t(x["g"]))
    for name, t, w in zip(("first", "second", "third"), targs, vjp(jnp.asarray(x["g"]))):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(w), rtol=0, atol=1e-5,
                                   err_msg=name)
    assert _launches() == before


def test_slice_patches_matches_jax_bit_for_bit():
    """Band-grid extraction and its window_accumulate backward (Pallas
    interpret mode on the JAX side), bit for bit, B = 2."""
    rng = np.random.RandomState(2)
    vl = rng.randn(2, 13, 17, 12).astype(np.float32)
    geo = _TileGeometry(SHAPES, (4, 4), (2, 2, 1, 1), 1)
    y0u, x0u = geo.patch_grid[0]
    _, _, ph, pw = geo.patches[0]
    want, vjp = jax.vjp(lambda v: jmsda._slice_patches(v, y0u, x0u, ph, pw), jnp.asarray(vl))
    tv = _t(vl).requires_grad_(True)
    got = msda_tiled.SlicePatchesFunction.apply(tv, y0u, x0u, ph, pw)
    np.testing.assert_array_equal(got.detach().numpy(), np.asarray(want))
    g = rng.randn(*got.shape).astype(np.float32)
    got.backward(_t(g))
    np.testing.assert_array_equal(tv.grad.numpy(), np.asarray(vjp(jnp.asarray(g))[0]))


ENCODER_SHAPES = ((36, 32), (18, 16), (9, 8), (5, 4))  # 3 x 4 tiles, patches < levels 0, 1


def _encoder_inputs(seed, heads=4, head_dim=8, points=4, max_offset=2.5):
    """Two images, Q == S tokens in raster order, locations = token centres
    + offsets of at most ``max_offset`` texels (inside the auto halos); in
    the second image a third of the tokens' locations are mirrored across
    the image, far outside their tiles' patches (the tiled forms clamp
    there and differ from the gather)."""
    bs = 2
    rng = np.random.RandomState(seed)
    total = sum(h * w for h, w in ENCODER_SHAPES)
    value = rng.randn(bs, total, heads, head_dim).astype(np.float32)
    refs = []
    for h, w in ENCODER_SHAPES:
        ys, xs = (np.arange(h) + 0.5) / h, (np.arange(w) + 0.5) / w
        refs.append(np.stack(np.meshgrid(xs, ys), -1).reshape(-1, 2))
    refs = np.concatenate(refs, 0)
    norm = np.array([(w, h) for h, w in ENCODER_SHAPES], np.float32)
    off = rng.uniform(-max_offset, max_offset,
                      (bs, total, heads, len(ENCODER_SHAPES), points, 2))
    locs = (refs[None, :, None, None, None, :] + off / norm[None, None, None, :, None, :])
    locs = locs.astype(np.float32)
    locs[1, 1::3] = 1.0 - locs[1, 1::3]
    attn = rng.rand(bs, total, heads, len(ENCODER_SHAPES), points)
    attn /= attn.reshape(bs, total, heads, -1).sum(-1)[..., None, None]
    cot = rng.randn(bs, total, heads * head_dim).astype(np.float32)
    return value, locs, attn.astype(np.float32), cot


@pytest.mark.parametrize("impl,sep", [("tiled", False), ("tiled_xla", False),
                                      ("tiled_xla", True)],
                         ids=["tiled", "tiled_xla", "tiled_xla_sep"])
def test_tiled_msda_matches_jax(impl, sep):
    """multi_scale_deformable_attention under each tiled form against the
    JAX function under the same msda_defaults: output 1e-5 abs, grads of
    value, locations and weights within 1e-4 of each one's max. In the
    halo (first image) both equal the gather; out of it (second) both clamp
    to the patch border."""
    value, locs, attn, cot = _encoder_inputs(3, heads=2 if impl == "tiled" else 4)
    with jmsda.msda_defaults(impl=impl, tiled_sep_kernel=sep):
        want, vjp = jax.vjp(lambda v, l, a: jmsda.multi_scale_deformable_attention(
            v, ENCODER_SHAPES, l, a), jnp.asarray(value), jnp.asarray(locs), jnp.asarray(attn))
        jgrads = vjp(jnp.asarray(cot))
    targs = [_t(a).requires_grad_(True) for a in (value, locs, attn)]
    before = _launches()
    with msda.msda_defaults(impl=impl, tiled_sep_kernel=sep):
        got = msda.multi_scale_deformable_attention(targs[0], ENCODER_SHAPES, targs[1], targs[2])
    got.backward(_t(cot))
    assert _launches() == before
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=0, atol=1e-5)
    gather = msda.msda_reference(_t(value), ENCODER_SHAPES, _t(locs), _t(attn))
    differs = (got.detach() - gather).abs().amax(dim=(1, 2))
    assert differs[0] < 1e-5 and differs[1] > 1e-3, differs  # clamped only out of the halo
    for name, t, w in zip(("value", "locations", "weights"), targs, jgrads):
        w = np.asarray(w)
        np.testing.assert_allclose(t.grad.numpy(), w, rtol=0, atol=1e-4 * np.abs(w).max(),
                                   err_msg=name)


def test_msda_settings_not_ported_raise():
    """Every setting the port once refused is now taken and set as the JAX
    package sets it (the port's impl default aside), and a tiled call under
    it runs; an unknown impl still raises; the defaults come back after the
    context."""
    saved = dict(msda._MSDA_DEFAULTS)
    with msda.msda_defaults(impl="tiled", tiled_halos="auto", tiled_slab_order="yx",
                            tiled_dtype=torch.float32, tiled_margin=1,
                            tiled_tile_tokens=(12, 8)):
        assert msda._MSDA_DEFAULTS["impl"] == "tiled"
    assert msda._MSDA_DEFAULTS == saved and saved["impl"] == "gather"
    value, locs, attn, _ = _encoder_inputs(3, heads=2)
    args = (_t(value), ENCODER_SHAPES, _t(locs), _t(attn))
    jdtypes = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}
    threads = torch.get_num_threads()
    torch.set_num_threads(1)  # beside other test processes, one thread is the quickest
    for settings in (dict(impl="corner_pack"), dict(tiled_halos=(2, 2, 2, 2)),
                     dict(tiled_overflow=8), dict(tiled_layout="t_major"),
                     dict(tiled_slab_order="bm"), dict(tiled_patch_mode="gather"),
                     dict(tiled_int8_slab=True), dict(tiled_dtype=torch.bfloat16),
                     dict(tiled_dot_bf16=True), dict(tiled_batch_unroll=True),
                     dict(tiled_margin=2)):
        jsettings = {k: jdtypes.get(v, v) if k == "tiled_dtype" else v
                     for k, v in settings.items()}
        with msda.msda_defaults(**settings), jmsda.msda_defaults(**jsettings):
            for key, setting in settings.items():
                want = jmsda._MSDA_DEFAULTS[key]
                assert msda._MSDA_DEFAULTS[key] == (setting if key == "tiled_dtype" else want)
            with msda.msda_defaults(impl=None if "impl" in settings else "tiled_xla"), \
                    torch.no_grad():
                out = msda.multi_scale_deformable_attention(*args)
            assert out.shape == (2, value.shape[1], 16) and torch.isfinite(out).all()
    torch.set_num_threads(threads)
    with pytest.raises(ValueError):
        msda.set_msda_defaults(impl="tiles")
    with msda.msda_defaults(gather_dtype=torch.bfloat16):
        assert msda._MSDA_DEFAULTS["gather_dtype"] == torch.bfloat16
    assert msda._MSDA_DEFAULTS == saved


@pytest.mark.parametrize("version", [1, 2])
def test_relation_bias_from_rel_matches_jax(version):
    """fused_relation_bias (the relation-tensor bias of versions 1 and 2):
    forward against the JAX Pallas kernel of that version (interpret mode)
    at 1e-5 abs (same angles, other summation order); kernel and
    bias grads against jax.vjp at 1e-4 of each max; zero rel grad on both
    sides."""
    rng = np.random.RandomState(version)
    rel = rng.randn(2, 33, 47, 4).astype(np.float32)
    kernel = (rng.randn(64, 8) * 0.1).astype(np.float32)
    bias = (rng.randn(8) * 0.1).astype(np.float32)
    cot = rng.randn(2, 8, 33, 47).astype(np.float32)
    saved = dict(jrel._FUSED)
    try:
        jrel.set_fused_relation(version=version)
        want, vjp = jax.vjp(jrel.fused_relation_bias, *(jnp.asarray(a) for a in (rel, kernel,
                                                                                  bias)))
        jgrads = vjp(jnp.asarray(cot))
    finally:
        jrel._FUSED.update(saved)
    targs = [_t(a).requires_grad_(True) for a in (rel, kernel, bias)]
    got = trel.fused_relation_bias(*targs)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=0, atol=1e-5)
    got.backward(_t(cot))
    assert not np.asarray(jgrads[0]).any() and not targs[0].grad.any()
    for name, t, w in zip(("kernel", "bias"), targs[1:], jgrads[1:]):
        w = np.asarray(w)
        np.testing.assert_allclose(t.grad.numpy(), w, rtol=0, atol=1e-4 * np.abs(w).max(),
                                   err_msg=name)
    assert trel.fused_relation_bias.launches == 0


def test_relation_versions_route_on_cpu_to_v4_plain():
    """set_fused_relation picks the bias on CUDA tensors only; CPU tensors
    keep the v4 math's plain version whatever the setting."""
    from relation_detr_tpu_torch.models.relation import (
        PositionRelationEmbedding,
        box_rel_encoding,
        separable_relation_bias,
    )

    emb = PositionRelationEmbedding()
    emb.init_weights(torch.Generator().manual_seed(0))
    rng = np.random.RandomState(4)
    src = _t(rng.rand(1, 12, 4).astype(np.float32) * 0.9 + 0.01)
    tgt = _t(rng.rand(1, 9, 4).astype(np.float32) * 0.9 + 0.01)
    kernel = emb.pos_proj[0].weight.reshape(8, 64).t().contiguous()
    with torch.no_grad():
        want = trel.relation_bias_v4_reference(src, tgt, kernel, emb.pos_proj[0].bias)
        for version in (1, 3):
            trel.set_fused_relation(version=version)
            try:
                np.testing.assert_array_equal(emb(src, tgt).numpy(), want.numpy())
            finally:
                trel.set_fused_relation(version=4)
        # the other routes compute the same bias (separable regrouping noise)
        direct = trel.fused_relation_bias_reference(box_rel_encoding(src, tgt), kernel,
                                                    emb.pos_proj[0].bias)
        sep = separable_relation_bias(src, tgt, kernel, emb.pos_proj[0].bias)
    np.testing.assert_allclose(direct.numpy(), want.numpy(), atol=5e-4)
    np.testing.assert_allclose(sep.numpy(), want.numpy(), atol=5e-4)
    with pytest.raises(ValueError):
        trel.set_fused_relation(version=5)


def test_tiny_detector_tiled_matches_jax():
    """The toy detector's pre-top-k heads under impl="tiled" against the
    JAX detector under msda_defaults(impl="tiled"), same perturbed weights:
    2e-3, as tests/test_torch_detector.py."""
    model_args = dict(num_classes=7, embed_dim=64, dim_feedforward=128, num_heads=4,
                      num_queries=20, hybrid_num_proposals=30, transformer_enc_layers=1,
                      transformer_dec_layers=2, backbone_arch="resnet18")
    model = RelationDETR(**model_args, generator=torch.Generator().manual_seed(0)).eval()
    rng = np.random.RandomState(8)
    sd = {k: v.numpy() for k, v in model.state_dict().items()}
    noisy = perturb({k: v for k, v in sd.items()
                     if not k.startswith("backbone.") or "bn" in k or "downsample.1" in k},
                    rng, 0.02)
    model.load_state_dict({k: torch.from_numpy(v) for k, v in {**sd, **noisy}.items()})
    params, stats, leftover = convert_state_dict(dict(model.state_dict()))
    assert not leftover, leftover[:8]
    images = rng.randn(2, 128, 160, 3).astype(np.float32)
    mask = np.zeros((2, 128, 160), bool)
    mask[1, 96:] = True
    mask[1, :, 112:] = True
    images[mask] = 0.0
    jmodel = JRelationDETR(**model_args)
    with jmsda.msda_defaults(impl="tiled"):
        jout = jax.jit(lambda v, x, m: jmodel.apply(v, x, m, train=False))(
            {"params": unflatten(params), "batch_stats": unflatten(stats)},
            jnp.asarray(images), jnp.asarray(mask))
    before = _launches()
    with msda.msda_defaults(impl="tiled"), torch.no_grad():
        tout = model(_t(images), _t(mask))
    assert _launches() == before
    for name in ("pred_logits", "pred_boxes"):
        np.testing.assert_allclose(tout[name].numpy(), np.asarray(jout[name]), rtol=2e-3,
                                   atol=2e-3, err_msg=name)
