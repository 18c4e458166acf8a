"""The port's ViT and EVA-02 backbones (with the SimpleFeaturePyramid) against
the JAX package, on the same numpy inputs.

Two tiny archs go into the JAX and the port ``ARCH_SETTINGS`` alike
(``monkeypatch.setitem``; no file of the JAX package changes): a plain ViT
and an EVA-02 with RoPE and SwiGLU, dim 32, 4 blocks, 2 heads, global blocks
1 and 3, windows of 4. A 1x144x176 image gives a 9x11 token grid, which the
windowed blocks pad to 12x12. Each backbone returns all four pyramid stages
(the 4x one has both transposed convs) on JAX-initialised weights, perturbed
and carried across by ``state_dict_from_jax``: outputs within 1e-4 of each
output's max |x|, gradients of a fixed cotangent against ``jax.grad`` within
1e-3 of each leaf's max. Then ``ResBottleneckBlock`` alone, the RoPE tables
on a rectangular grid, a tiny EVA detector's heads before the two-stage
top-k at 2e-3, the weight bridge both ways, the four full archs' parameter
trees (the port on ``meta``, JAX by ``jax.eval_shape``), and the bf16
policy. The JAX side runs jitted; torch runs on one thread.
"""
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, ".")
from relation_detr_tpu.models.backbones import vit as jvit  # noqa: E402
from relation_detr_tpu.models.detector import RelationDETR as JRelationDETR  # noqa: E402
from relation_detr_tpu_torch.models import backbones, layers  # noqa: E402
from relation_detr_tpu_torch.models.backbones import vit  # noqa: E402
from relation_detr_tpu_torch.models.detector import RelationDETR  # noqa: E402
from relation_detr_tpu_torch.utils.param_groups import build_optimizer  # noqa: E402
from relation_detr_tpu_torch.utils.weights import (  # noqa: E402
    jax_key_label,
    jax_weights,
    load_weights,
    state_dict_from_jax,
)
from tests.test_torch_backbones import (  # noqa: E402
    TINY,
    TOL_GRAD,
    TOL_HEADS,
    TOL_OUT,
    _batch,
    _jax_param_shapes,
    _round_trip,
    _shapes,
    _t,
)
from tests.test_torch_families import _quick_jit  # noqa: E402
from tests.test_torch_modules import flatten, perturb, strip, unflatten  # noqa: E402

TINY_ARCHS = {
    "vit_tiny_test": dict(dim=32, depth=4, num_heads=2, mlp_dim=64, global_idx=(1, 3),
                          rope=False, swiglu=False, window_size=4),
    "eva_02_vit_tiny_test": dict(dim=32, depth=4, num_heads=2, mlp_dim=48, global_idx=(1, 3),
                                 rope=True, swiglu=True, window_size=4),
}
ALL_STAGES = (0, 1, 2, 3)
IMAGE_HW = (144, 176)  # a 9x11 token grid


@pytest.fixture(scope="module", autouse=True)
def tiny_archs():
    """The tiny entries in both tables, and torch on one thread."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    with pytest.MonkeyPatch.context() as mp:
        for arch, entry in TINY_ARCHS.items():
            mp.setitem(jvit.ARCH_SETTINGS, arch, entry)
            mp.setitem(vit.ARCH_SETTINGS, arch, entry)
        yield
    torch.set_num_threads(threads)


def _bridged(tree, prefix="backbone"):
    sd = state_dict_from_jax({f"{prefix}/{k}": v for k, v in flatten(tree).items()}, {})
    return strip(sd, f"{prefix}.")


def _compare_grads(module, jgrads, label):
    params = dict(module.named_parameters())
    assert sorted(params) == sorted(jgrads)
    for name, param in params.items():
        got, want = param.grad.numpy(), jgrads[name].numpy()
        assert np.isfinite(got).all(), name
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=TOL_GRAD * float(np.abs(want).max()) + 1e-12,
                                   err_msg=f"{label} {name}")


def _run_pair(jmodule, tmodule, params, x_nhwc, rng, to_port, from_port, prefix="backbone"):
    """Forward and the gradient of sum(out * cotangent) on both sides, the
    port loaded with ``params`` through the bridge. ``to_port`` /
    ``from_port`` map an input / output between the JAX NHWC layout and the
    port's."""
    outs = jax.eval_shape(lambda p: jmodule.apply({"params": p}, jnp.asarray(x_nhwc)), params)
    outs = outs if isinstance(outs, (tuple, list)) else [outs]
    cots = [rng.randn(*o.shape).astype(np.float32) for o in outs]

    def loss(p, x):
        out = jmodule.apply({"params": p}, x)
        out = out if isinstance(out, (tuple, list)) else [out]
        return sum(jnp.sum(o * c) for o, c in zip(out, cots)), out

    (_, jouts), jgrads = _quick_jit(jax.value_and_grad(loss, has_aux=True))(
        params, jnp.asarray(x_nhwc))
    tmodule.load_state_dict(_bridged(params, prefix))
    touts = tmodule(to_port(_t(x_nhwc)))
    touts = touts if isinstance(touts, (tuple, list)) else [touts]
    sum((from_port(o) * _t(c)).sum() for o, c in zip(touts, cots)).backward()
    return jouts, [from_port(o).detach().numpy() for o in touts], _bridged(jgrads, prefix)


@pytest.fixture(scope="module", params=list(TINY_ARCHS))
def vit_run(request):
    """One tiny backbone returning all four stages on each side, same
    perturbed JAX-initialised weights: outputs and gradients."""
    arch = request.param
    rng = np.random.RandomState(3)
    x = rng.randn(1, *IMAGE_HW, 3).astype(np.float32)
    jbb = jvit.VisionTransformerBackbone(arch=arch, return_indices=ALL_STAGES)
    init = _quick_jit(lambda k: jbb.init(k, jnp.zeros((1, 64, 96, 3)))["params"])(
        jax.random.key(0, impl="unsafe_rbg"))
    params = unflatten(perturb(flatten(init), rng, 0.05))
    model = vit.VisionTransformerBackbone(arch, return_indices=ALL_STAGES)
    jouts, touts, jgrads = _run_pair(jbb, model, params, x, rng,
                                     lambda t: t.permute(0, 3, 1, 2),
                                     lambda t: t.permute(0, 2, 3, 1))
    return dict(arch=arch, model=model, jouts=jouts, touts=touts, jgrads=jgrads)


def test_vit_pyramid_matches_jax(vit_run):
    """Every pyramid stage (strides 4 / 8 / 16 / 32; 36x44, 18x22, 9x11, 4x5),
    NCHW against the JAX NHWC output, within 1e-4 of its max |x|; the
    backbone's ``num_channels`` as JAX's."""
    run = vit_run
    assert run["model"].num_channels == (256,) * 4
    assert vit.VisionTransformerBackbone(run["arch"]).num_channels == \
        jvit.VisionTransformerBackbone(arch=run["arch"]).num_channels
    shapes = [(1, 36, 44, 256), (1, 18, 22, 256), (1, 9, 11, 256), (1, 4, 5, 256)]
    for i, (got, want) in enumerate(zip(run["touts"], run["jouts"])):
        want = np.asarray(want)
        assert got.shape == want.shape == shapes[i] and got.dtype == np.float32, i
        np.testing.assert_allclose(got, want, rtol=0, atol=TOL_OUT * np.abs(want).max(),
                                   err_msg=f"{run['arch']} pyramid stage {i}")


def test_vit_grads_match_jax(vit_run):
    """Every parameter's gradient (patch embedding, each block's norms,
    attention and MLP, the transposed convs and projections) against
    jax.grad within 1e-3 of the leaf's max |grad|; nothing frozen."""
    run = vit_run
    assert all(p.requires_grad for p in run["model"].parameters())
    _compare_grads(run["model"], run["jgrads"], run["arch"])


def test_res_bottleneck_block_matches_jax():
    """``ResBottleneckBlock`` (which neither backbone calls) on perturbed
    weights (``norm3`` starts at zero): output and every gradient."""
    rng = np.random.RandomState(4)
    x = rng.randn(2, 9, 11, 16).astype(np.float32)
    jblock = jvit.ResBottleneckBlock(features=16, bottleneck=8)
    init = jblock.init(jax.random.key(1), jnp.asarray(x))["params"]
    assert not np.asarray(init["norm3"]["scale"]).any()
    params = unflatten(perturb(flatten(init), rng, 0.1))
    block = vit.ResBottleneckBlock(16, 8)
    layers.init_weights(block, torch.Generator().manual_seed(0))
    assert not block.norm3.weight.any() and not block.norm3.bias.any()
    jouts, touts, jgrads = _run_pair(jblock, block, params, x, rng, lambda t: t, lambda t: t,
                                     prefix="block")
    np.testing.assert_allclose(touts[0], np.asarray(jouts[0]), rtol=0,
                               atol=TOL_OUT * np.abs(np.asarray(jouts[0])).max())
    _compare_grads(block, jgrads, "ResBottleneckBlock")


def test_rope_matches_jax():
    """The rotary tables on a rectangular 9x11 grid and a 4x4 window equal
    JAX's exactly; ``_apply_rope`` on random q against JAX's, interleaved
    pairs (x0, x1) -> (-x1, x0)."""
    for grid in ((9, 11), (4, 4)):
        for got, want in zip(vit._rope_tables(16, 16, grid), jvit._rope_tables(16, 16, grid)):
            np.testing.assert_array_equal(got, want)
    rng = np.random.RandomState(5)
    q = rng.randn(2, 99, 2, 16).astype(np.float32)
    cos, sin = vit._rope_tables(16, 16, (9, 11))
    want = np.asarray(jvit._apply_rope(jnp.asarray(q), cos[:, None], sin[:, None]))
    got = vit._apply_rope(_t(q), _t(cos)[:, None], _t(sin)[:, None]).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(vit._rotate_half(torch.tensor([1.0, 2.0, 3.0, 4.0])),
                                  [-2.0, 1.0, -4.0, 3.0])


@pytest.fixture(scope="module")
def eva_detector():
    """A tiny detector on the tiny EVA on each side, the port's seeded
    weights (perturbed) carried to JAX by ``jax_weights``: the eval forward
    with the encoder's heads over every token before the two-stage top-k."""
    arch = "eva_02_vit_tiny_test"
    rng = np.random.RandomState(11)
    model = RelationDETR(**TINY, backbone_arch=arch, generator=torch.Generator().manual_seed(0))
    sd = {k: v.numpy() for k, v in model.state_dict().items()}
    model.load_state_dict({k: _t(v) for k, v in perturb(sd, rng, 0.02).items()})
    arrays = jax_weights(model)
    images, mask = _batch(rng)
    jmodel = JRelationDETR(**TINY, backbone_arch=arch)
    names = ("encoder_class_head", "encoder_bbox_head")
    jout, inter = _quick_jit(lambda v, x, m: jmodel.apply(
        v, x, m, train=False, capture_intermediates=lambda mdl, _: mdl.name in names,
        mutable=["intermediates"]))(
        {"params": unflatten({k[len("params/"):]: v for k, v in arrays.items()})},
        jnp.asarray(images), jnp.asarray(mask))
    jpre = {n: np.asarray(inter["intermediates"]["transformer"][n]["__call__"][0])
            for n in names}
    tpre = {}
    hooks = [getattr(model.transformer, n).register_forward_hook(
        lambda mod, a, out, n=n: tpre.__setitem__(n, out.numpy())) for n in names]
    with torch.no_grad():
        tout = model(_t(images), _t(mask))
    for hook in hooks:
        hook.remove()
    return dict(model=model, arrays=arrays, jout=jout, tout=tout, jpre=jpre, tpre=tpre,
                jax_shapes=_jax_param_shapes(jmodel, images, mask))


def test_eva_detector_heads_match_jax(eva_detector):
    """The encoder's class logits and boxes over every token before the
    top-k, and the decoder's heads, at 2e-3."""
    run = eva_detector
    for name, want in run["jpre"].items():
        np.testing.assert_allclose(run["tpre"][name], want, rtol=TOL_HEADS, atol=TOL_HEADS,
                                   err_msg=f"{name} before the top-k")
    for key in ("pred_logits", "pred_boxes"):
        got, want = run["tout"][key].numpy(), np.asarray(run["jout"][key])
        assert got.shape == want.shape and np.isfinite(got).all(), key
        np.testing.assert_allclose(got, want, rtol=TOL_HEADS, atol=TOL_HEADS, err_msg=key)


def test_vit_weight_bridge_round_trip(eva_detector, tmp_path):
    """``jax_weights`` of the EVA detector gives exactly the JAX model's
    parameter tree (the backbone's q / k / v three tensors, k without a
    bias), ``state_dict_from_jax`` gives every tensor back bit for bit, and
    ``load_weights`` reads the weight file into a fresh model strictly (the
    backbone's projections as three tensors, the transformer's merged)."""
    run = eva_detector
    arrays = run["arrays"]
    assert {k[len("params/"):]: tuple(v.shape) for k, v in arrays.items()} == \
        run["jax_shapes"]["params"]
    assert "params/backbone/block0/attn/k_proj/kernel" in arrays
    assert "params/backbone/block0/attn/k_proj/bias" not in arrays
    _round_trip(arrays, run["model"].state_dict())
    np.savez(tmp_path / "eva.npz", **arrays)
    fresh = RelationDETR(**TINY, backbone_arch="eva_02_vit_tiny_test",
                         generator=torch.Generator().manual_seed(1))
    report = load_weights(fresh, str(tmp_path / "eva.npz"), strict=True)
    assert "backbone.block0.attn.k_proj.weight" in report["loaded"]
    for name, value in run["model"].state_dict().items():
        assert torch.equal(fresh.state_dict()[name], value), name


def test_conv_transpose_bridge_flips_the_kernel():
    """A flax ``ConvTranspose`` (2x2/s2, SAME, unflipped HWIO kernel) and the
    port's ``ConvTranspose2d`` with the bridged weight give the same map;
    the bridge both ways is bit for bit, and the weight is flipped in space
    (not merely transposed)."""
    from flax import linen as fnn

    rng = np.random.RandomState(6)
    x = rng.randn(1, 3, 5, 4).astype(np.float32)
    conv = fnn.ConvTranspose(6, (2, 2), strides=(2, 2))
    params = conv.init(jax.random.key(2), jnp.asarray(x))["params"]
    params = unflatten(perturb(flatten(params), rng, 0.1))
    want = np.asarray(conv.apply({"params": params}, jnp.asarray(x)))
    sd = state_dict_from_jax({f"backbone/fpn1_up1/{k}": v for k, v in flatten(params).items()},
                             {})
    kernel = np.asarray(params["kernel"])
    assert not np.array_equal(sd["backbone.fpn1_up1.weight"].numpy(),
                              kernel.transpose(2, 3, 0, 1))
    holder = torch.nn.Module()
    holder.backbone = torch.nn.Module()
    holder.backbone.fpn1_up1 = torch.nn.ConvTranspose2d(4, 6, 2, 2)
    holder.load_state_dict(sd)
    got = holder.backbone.fpn1_up1(_t(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=1e-6, atol=1e-6)
    arrays = jax_weights(holder)
    np.testing.assert_array_equal(arrays["params/backbone/fpn1_up1/kernel"], kernel)


@pytest.mark.parametrize("arch", list(jvit.ARCH_SETTINGS))
def test_full_arch_params_match_jax(arch):
    """Each full arch's backbone, the port built on ``meta`` (no compute),
    has the JAX backbone's parameters (``jax.eval_shape`` of its init)
    through the bridge's names and layouts, and nothing else."""
    with torch.device("meta"):
        holder = torch.nn.Module()
        holder.backbone = backbones.build_backbone(arch)
    assert isinstance(holder.backbone, backbones.VisionTransformerBackbone)
    sd = {k: tuple(v.shape) for k, v in holder.state_dict().items()}
    jbb = jvit.VisionTransformerBackbone(arch=arch)
    tree = jax.eval_shape(lambda: jbb.init(jax.random.key(0), jnp.zeros((1, 64, 96, 3))))
    assert set(tree) == {"params"}
    want = {}
    for key, shape in _shapes(tree["params"]).items():
        name = jax_key_label(f"params/backbone/{key}", vit=True)
        if key.endswith("kernel") and len(shape) == 4:
            shape = (shape[2], shape[3], shape[0], shape[1]) if "_up" in key else \
                (shape[3], shape[2], shape[0], shape[1])
        elif key.endswith("kernel"):
            shape = tuple(reversed(shape))
        want[name] = shape
    assert want == sd


def test_bf16_policy_keeps_vit_fp32():
    """Under ``backbone_dtype`` = ``compute_dtype`` = bf16 the EVA backbone
    stays fp32 (JAX gives the dtype to the ResNet only): no module in it
    has a compute dtype, its outputs equal the fp32 model's bit for bit,
    nothing in it is frozen and the optimizer holds all of it."""
    rng = np.random.RandomState(5)
    images, mask = _batch(rng)
    outs = {}
    for policy in (None, "bfloat16"):
        model = RelationDETR(**TINY, backbone_arch="eva_02_vit_tiny_test", backbone_dtype=policy,
                             compute_dtype=policy, generator=torch.Generator().manual_seed(0))
        assert all(getattr(m, "compute_dtype", None) is None for m in model.backbone.modules())
        hook = model.backbone.register_forward_hook(
            lambda mod, args, out, p=policy: outs.__setitem__(p, out))
        with torch.no_grad():
            model(_t(images), _t(mask))
        hook.remove()
        params = list(model.backbone.parameters())
        assert all(p.requires_grad and p.dtype == torch.float32 for p in params)
        held = {id(p) for g in build_optimizer(model, 1e-4).param_groups for p in g["params"]}
        assert all(id(p) in held for p in params)
    for got, want in zip(outs["bfloat16"], outs[None]):
        assert got.dtype == torch.float32 and torch.equal(got, want)
