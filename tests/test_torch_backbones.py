"""The port's Swin (v1, v2), ConvNeXt and FocalNet backbones against the JAX
package, on the same numpy inputs.

Tiny arch entries go into the JAX and the port ``ARCH_SETTINGS`` alike
(``monkeypatch.setitem``; no file of the JAX package changes). On a
1x120x184 image Swin's stride-4 grid is 30x46: each stage pads to whole
windows, the shift is on in stages 0-2 and off in stage 3 (v1, window 7),
and ``PatchMerging`` pads the odd 15x23. Each backbone runs on JAX-initialised
weights (perturbed, so that layer scales of 1e-6 cannot hide a layout bug)
carried across by ``state_dict_from_jax``: stage outputs within 1e-4 of each
output's max |x|, gradients of a fixed cotangent against ``jax.grad`` within
1e-3 of each leaf's max. Then a tiny detector per family (the port's seeded
weights carried to JAX by ``jax_weights``): the encoder's heads before the
two-stage top-k and the decoder's heads at 2e-3; the weight bridge both ways
and ``convert_state_dict`` on a Swin state_dict; the bf16 policy; the four
full configs' parameter trees (the port on the ``meta`` device, the JAX
model traced by ``jax.eval_shape``). The JAX side runs jitted; torch runs on
one thread.
"""
import dataclasses
import functools
import inspect
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, ".")
from tools.convert_torch_weights import convert_state_dict  # noqa: E402

from relation_detr_tpu.models import backbones as jbackbones  # noqa: E402
from relation_detr_tpu.models.backbones import convnext as jconvnext  # noqa: E402
from relation_detr_tpu.models.backbones import focalnet as jfocalnet  # noqa: E402
from relation_detr_tpu.models.backbones import swin as jswin  # noqa: E402
from relation_detr_tpu.models.backbones import vit as jvit  # noqa: E402
from relation_detr_tpu.models.detector import RelationDETR as JRelationDETR  # noqa: E402
from relation_detr_tpu.utils.config import Config as JConfig  # noqa: E402
from relation_detr_tpu_torch.models import backbones, layers  # noqa: E402
from relation_detr_tpu_torch.models.backbones import convnext, focalnet, swin  # noqa: E402
from relation_detr_tpu_torch.models.deform_conv import DeformConv2dPack  # noqa: E402
from relation_detr_tpu_torch.models.detector import RelationDETR  # noqa: E402
from relation_detr_tpu_torch.utils.config import Config  # noqa: E402
from relation_detr_tpu_torch.utils.param_groups import build_optimizer  # noqa: E402
from relation_detr_tpu_torch.utils.weights import (  # noqa: E402
    jax_key_label,
    jax_weights,
    state_dict_from_jax,
)
from tests.test_torch_families import _quick_jit  # noqa: E402
from tests.test_torch_modules import flatten, perturb, strip, unflatten  # noqa: E402

# tiny archs: (module of the JAX package, module of the port, entry)
TINY_ARCHS = {
    "swin_tiny_test": (jswin, swin, (16, (2, 2, 2, 2), (2, 2, 4, 8), 7, False)),
    "swin_v2_tiny_test": (jswin, swin, (16, (2, 2, 2, 2), (2, 2, 4, 8), 8, True)),
    "convnext_tiny_test": (jconvnext, convnext, ((8, 16, 32, 64), (1, 1, 2, 1))),
    "focalnet_tiny_test_off": (jfocalnet, focalnet,
                               (16, (1, 1, 1, 1), (2,) * 4, (3,) * 4) + (False,) * 4),
    "focalnet_tiny_test_on": (jfocalnet, focalnet,
                              (16, (1, 1, 1, 1), (4,) * 4, (3,) * 4) + (True,) * 4),
}
DETECTOR_ARCHS = ("swin_tiny_test", "convnext_tiny_test", "focalnet_tiny_test_on")
TINY = dict(num_classes=10, embed_dim=64, dim_feedforward=128, num_heads=8, num_queries=30,
            hybrid_num_proposals=40, denoising_nums=4, transformer_enc_layers=1,
            transformer_dec_layers=2)
B, H, W = 2, 96, 128
TOL_OUT = 1e-4  # of each stage output's max |x|
TOL_GRAD = 1e-3  # of each leaf's max |grad|
TOL_HEADS = 2e-3
# the four large configs (port, JAX); the two FocalNet-L ones share a model
CONFIGS = {
    "swin_l": "relation_detr/relation_detr_swin_l_800_1333.py",
    "convnext_l": "relation_detr/relation_detr_convnext_l_800_1333.py",
    "focalnet_l": "relation_detr/relation_detr_focalnet_large_lrf_fl4_800_1333.py",
    "focalnet_l_1200": "relation_detr/relation_detr_focalnet_large_lrf_fl4_1200_2000.py",
}


@pytest.fixture(scope="module", autouse=True)
def tiny_archs():
    """The tiny entries in both tables, and torch on one thread."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    with pytest.MonkeyPatch.context() as mp:
        for arch, (jmod, tmod, entry) in TINY_ARCHS.items():
            mp.setitem(jmod.ARCH_SETTINGS, arch, entry)
            mp.setitem(tmod.ARCH_SETTINGS, arch, entry)
        yield
    torch.set_num_threads(threads)


def _t(x):
    return torch.from_numpy(np.array(x))


# backbone cases: (arch, image h, w). Swin v2 also on a 256x256 image, where
# no stage pads (window 8): on a padded map JAX's gradient is NaN in the k
# rows of qkv (``swin.WindowAttention``), so only there do all leaves compare.
BACKBONE_CASES = {**{arch: (arch, 120, 184) for arch in TINY_ARCHS},
                  "swin_v2_unpadded": ("swin_v2_tiny_test", 256, 256)}


@functools.lru_cache(maxsize=None)
def _jax_init(arch):
    """The JAX backbone's initial parameters, flat (an init compiles the
    forward too: once per arch; the unsafe_rbg generator compiles its draws
    in about half threefry's time)."""
    jbb = jbackbones.build_backbone(arch)
    x = jnp.zeros((1, 64, 96, 3))
    return flatten(_quick_jit(lambda k: jbb.init(k, x)["params"])(
        jax.random.key(0, impl="unsafe_rbg")))


@pytest.fixture(scope="module", params=list(BACKBONE_CASES))
def backbone_run(request):
    """One backbone on each side with the same (perturbed, JAX-initialised)
    weights: the stage outputs and the gradients of sum(out * cotangent)."""
    arch, h, w = BACKBONE_CASES[request.param]
    rng = np.random.RandomState(7)
    x = rng.randn(1, h, w, 3).astype(np.float32)
    jbb = jbackbones.build_backbone(arch)
    params = unflatten(perturb(_jax_init(arch), rng, 0.05))
    outs = jax.eval_shape(lambda p: jbb.apply({"params": p}, jnp.asarray(x)), params)
    cots = [rng.randn(*o.shape).astype(np.float32) for o in outs]

    def loss(p, x):
        outs = jbb.apply({"params": p}, x)
        return sum(jnp.sum(o * c) for o, c in zip(outs, cots)), outs

    (_, jouts), jgrads = _quick_jit(jax.value_and_grad(loss, has_aux=True))(params, jnp.asarray(x))

    def bridged(tree):
        sd = state_dict_from_jax({f"backbone/{k}": v for k, v in flatten(tree).items()}, {})
        return strip(sd, "backbone.")

    model = backbones.build_backbone(arch)
    model.load_state_dict(bridged(params))
    touts = model(_t(x).permute(0, 3, 1, 2))
    sum((o.permute(0, 2, 3, 1) * _t(c)).sum() for o, c in zip(touts, cots)).backward()
    return dict(case=request.param, arch=arch, model=model, jouts=jouts, touts=touts,
                jgrads=bridged(jgrads))


def test_backbone_matches_jax(backbone_run):
    """Every returned stage (strides 8/16/32), NCHW against the JAX NHWC
    output, within 1e-4 of its max |x|; ``num_channels`` as JAX's."""
    run = backbone_run
    assert run["model"].num_channels == jbackbones.build_backbone(run["arch"]).num_channels
    assert len(run["touts"]) == len(run["jouts"]) == 3
    for i, (got, want) in enumerate(zip(run["touts"], run["jouts"])):
        got, want = got.detach().permute(0, 2, 3, 1).numpy(), np.asarray(want)
        assert got.shape == want.shape and got.dtype == np.float32, i
        np.testing.assert_allclose(got, want, rtol=0, atol=TOL_OUT * np.abs(want).max(),
                                   err_msg=f"{run['arch']} stage output {i}")


def test_backbone_grads_match_jax(backbone_run):
    """Every parameter's gradient of the fixed cotangent against jax.grad,
    within 1e-3 of the leaf's max |grad|; nothing in the backbone frozen.
    Swin v2 on the padded 120x184 image: JAX's gradient is NaN in exactly
    the k rows of every block's ``qkv`` (weight and bias), the port's is
    finite there; every other element compares (all of them unpadded)."""
    run = backbone_run
    params = dict(run["model"].named_parameters())
    assert sorted(params) == sorted(run["jgrads"])
    nan_leaves = []
    for name, param in params.items():
        assert param.requires_grad and param.grad is not None, name
        got, want = param.grad.numpy(), run["jgrads"][name].numpy()
        assert np.isfinite(got).all(), name
        finite = np.isfinite(want)
        if not finite.all():
            c = want.shape[0] // 3
            assert name.endswith(("attn.qkv.weight", "attn.qkv.bias")), name
            assert not finite[c:2 * c].any() and finite[:c].all() and finite[2 * c:].all()
            nan_leaves.append(name)
        np.testing.assert_allclose(got[finite], want[finite], rtol=0,
                                   atol=TOL_GRAD * float(np.abs(want[finite]).max()) + 1e-12,
                                   err_msg=f"{run['case']} {name}")
    qkv = [n for n in params if n.endswith(("attn.qkv.weight", "attn.qkv.bias"))]
    assert nan_leaves == (qkv if run["case"] == "swin_v2_tiny_test" else [])


def test_swin_shifts_and_pads_like_jax():
    """On the 30x46 grid of a 120x184 image (window 7) every stage pads to
    whole windows; the odd blocks shift in stages 0-2 and not in stage 3
    (4x6, smaller than a window); PatchMerging pads 15x23 to 16x24."""
    model = backbones.build_backbone("swin_tiny_test")
    seen = []
    for stage in range(4):
        for block in model.features[2 * stage + 1]:
            block.attn.register_forward_hook(lambda mod, args, out, s=stage: seen.append(
                (s, mod.shift if min(args[0].shape[1:3]) > mod.window_size else 0,
                 tuple(args[0].shape[1:3]))))
    with torch.no_grad():
        model(torch.zeros(1, 3, 120, 184))
    assert seen == [(0, 0, (30, 46)), (0, 3, (30, 46)), (1, 0, (15, 23)), (1, 3, (15, 23)),
                    (2, 0, (8, 12)), (2, 3, (8, 12)), (3, 0, (4, 6)), (3, 0, (4, 6))]


def _shapes(tree):
    """'/'-keyed shapes of an abstract (``jax.eval_shape``) tree."""
    return {"/".join(str(getattr(k, "key", k)) for k in path): tuple(leaf.shape)
            for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _jax_param_shapes(jmodel, images, mask):
    """The JAX model's parameter and batch_stats shapes (an abstract init;
    these backbones have no batch_stats)."""
    b = images.shape[0]
    tree = jax.eval_shape(lambda: jmodel.init(
        {"params": jax.random.key(0), "denoising": jax.random.key(1)},
        jnp.asarray(images), jnp.asarray(mask), jnp.zeros((b, 4), jnp.int32),
        jnp.full((b, 4, 4), 0.5), jnp.zeros((b, 4), bool), train=True))
    return {name: _shapes(tree.get(name, {})) for name in ("params", "batch_stats")}


def _batch(rng):
    images = rng.randn(B, H, W, 3).astype(np.float32)
    mask = np.zeros((B, H, W), bool)
    mask[1, 72:] = True
    mask[1, :, 96:] = True
    images[mask] = 0.0
    return images, mask


@pytest.fixture(scope="module", params=DETECTOR_ARCHS)
def detector_run(request):
    """A tiny detector on each side, the port's seeded weights (perturbed)
    carried to JAX by ``jax_weights``: the eval forward, with the encoder's
    class and box heads over every token before the two-stage top-k."""
    arch = request.param
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
    return dict(arch=arch, model=model, arrays=arrays, jout=jout, tout=tout, jpre=jpre,
                tpre=tpre, jax_shapes=_jax_param_shapes(jmodel, images, mask))


def test_detector_heads_match_jax(detector_run):
    """The encoder's class logits and boxes over every token before the
    top-k, then every decoder layer's heads and the top-k's, at 2e-3."""
    run = detector_run
    for name, want in run["jpre"].items():
        np.testing.assert_allclose(run["tpre"][name], want, rtol=TOL_HEADS, atol=TOL_HEADS,
                                   err_msg=f"{run['arch']} {name} before the top-k")
    jout, tout = run["jout"], run["tout"]
    assert set(tout) == set(jout)
    pairs = [(k, tout[k], jout[k]) for k in ("pred_logits", "pred_boxes")]
    pairs += [(f"{s}/{k}", tout[s][k], jout[s][k]) for s in ("aux_outputs", "enc_outputs")
              for k in ("pred_logits", "pred_boxes")]
    for label, got, want in pairs:
        got, want = got.numpy(), np.asarray(want)
        assert got.shape == want.shape and np.isfinite(got).all(), label
        np.testing.assert_allclose(got, want, rtol=TOL_HEADS, atol=TOL_HEADS,
                                   err_msg=f"{run['arch']} {label}")


def test_weight_bridge_round_trip(detector_run):
    """``jax_weights`` gives exactly the JAX model's parameter tree (names
    and shapes; no batch_stats), and ``state_dict_from_jax`` gives every
    tensor back bit for bit (depthwise kernels, layer scales, the bias
    table); for Swin, ``convert_state_dict`` reads the port's state_dict
    with nothing left over and gives the same arrays."""
    run = detector_run
    arrays, sd = run["arrays"], run["model"].state_dict()
    assert {k[len("params/"):]: tuple(v.shape) for k, v in arrays.items()} == \
        run["jax_shapes"]["params"]
    assert not run["jax_shapes"]["batch_stats"]
    _round_trip(arrays, sd)
    if run["arch"].startswith("swin"):
        _converted_equal(sd, arrays)


def _round_trip(arrays, sd):
    back = state_dict_from_jax({k[len("params/"):]: v for k, v in arrays.items()}, {})
    assert sorted(back) == sorted(sd)
    for k, v in sd.items():
        assert torch.equal(back[k], v), k


def _converted_equal(sd, arrays):
    params, stats, leftover = convert_state_dict(dict(sd))
    assert not leftover and not stats, leftover[:8]
    assert sorted(f"params/{k}" for k in params) == sorted(arrays)
    for k, v in params.items():
        np.testing.assert_array_equal(v, arrays[f"params/{k}"], err_msg=k)


@pytest.mark.parametrize("arch", ("swin_tiny_test", "swin_v2_tiny_test"))
def test_swin_weight_bridge(arch):
    """A Swin backbone's parameters alone (v2: ``logit_scale`` and the CPB
    MLP too), seeded and perturbed: ``jax_weights`` gives the JAX
    backbone's tree (``jax.eval_shape`` of its init), ``state_dict_from_jax``
    every tensor back bit for bit, and ``convert_state_dict`` reads the
    port's state_dict with nothing left over and gives the same arrays."""
    holder = torch.nn.Module()
    holder.backbone = backbones.build_backbone(arch)
    layers.init_weights(holder, torch.Generator().manual_seed(3))
    sd = {k: v.numpy() for k, v in holder.state_dict().items()}
    holder.load_state_dict({k: _t(v) for k, v in perturb(sd, np.random.RandomState(3),
                                                         0.02).items()})
    arrays = jax_weights(holder)
    jbb = jbackbones.build_backbone(arch)
    tree = jax.eval_shape(lambda: jbb.init(jax.random.key(0), jnp.zeros((1, 64, 96, 3))))
    assert {k[len("params/backbone/"):]: tuple(v.shape) for k, v in arrays.items()} == \
        _shapes(tree["params"])
    _round_trip(arrays, holder.state_dict())
    _converted_equal(holder.state_dict(), arrays)


@pytest.mark.parametrize("arch", ("swin_v2_tiny_test", "convnext_tiny_test",
                                  "focalnet_tiny_test_on"))
def test_bf16_policy_keeps_backbone_fp32(arch):
    """Under ``backbone_dtype`` = ``compute_dtype`` = bf16 these backbones
    stay fp32 (JAX passes the dtype to the ResNet only): no module in them
    has a compute dtype, their outputs are fp32 and equal the fp32 model's
    bit for bit; nothing in them is frozen (JAX's ``is_frozen`` matches
    ResNet names only) and the optimizer holds all of them."""
    rng = np.random.RandomState(5)
    images, mask = _batch(rng)
    outs = {}
    for policy in (None, "bfloat16"):
        model = RelationDETR(**TINY, backbone_arch=arch, backbone_dtype=policy,
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
        assert any(getattr(m, "compute_dtype", None) == torch.bfloat16
                   for m in model.transformer.modules()) == (policy is not None)
    for got, want in zip(outs["bfloat16"], outs[None]):
        assert got.dtype == torch.float32
        assert torch.equal(got, want)


_FULL_SHAPES = {}


def _full_jax_shapes(jmodel):
    """``_jax_param_shapes`` of a full config's JAX model on a 320x384 canvas
    (1500 hybrid proposals need as many tokens), traced once per model (the
    two FocalNet-L configs share theirs)."""
    if jmodel not in _FULL_SHAPES:
        _FULL_SHAPES[jmodel] = _jax_param_shapes(
            jmodel, np.zeros((1, 320, 384, 3), np.float32), np.zeros((1, 320, 384), bool))
    return _FULL_SHAPES[jmodel]


def _expected_port_shape(key, shape):
    """The port's shape of a JAX parameter (HWIO kernels OIHW, dense
    kernels transposed, merged q/k/v parts their rows)."""
    if key.endswith("/kernel"):
        if len(shape) == 4:
            return (shape[3], shape[2], shape[0], shape[1])
        if key.split("/")[-2] == "pos_proj":
            return (shape[1], shape[0], 1, 1)
        return tuple(reversed(shape))
    return tuple(shape)


@pytest.mark.parametrize("config", list(CONFIGS))
def test_full_config_params_match_jax(config):
    """The full config's model, the port's built on the ``meta`` device, has
    the JAX model's parameters through the bridge's names and layouts: every
    JAX leaf (``jax.eval_shape`` of its init) is a port tensor of the
    matching shape, and the port has nothing else."""
    port = Config("relation_detr_tpu_torch/configs/" + CONFIGS[config])
    with torch.device("meta"):
        model = RelationDETR(**port.model_args)
    assert next(model.parameters()).device.type == "meta"
    sd = {k: tuple(v.shape) for k, v in model.state_dict().items()}
    jshapes = _full_jax_shapes(JConfig("configs/" + CONFIGS[config]).model)
    assert not jshapes["batch_stats"]
    covered = {}
    for key, shape in jshapes["params"].items():
        label = jax_key_label(f"params/{key}")
        name, _, part = label.partition("[")
        want = _expected_port_shape(key, shape)
        if part:
            covered[name] = covered.get(name, 0) + want[0]
            assert sd[name][1:] == want[1:], label
        else:
            covered[name] = sd.get(name)
            assert sd.get(name) == want, (label, sd.get(name), want)
    assert set(covered) == set(sd)
    assert all(covered[k] in (v, v[0]) for k, v in sd.items())


def _fields(obj, cls):
    return {f.name: getattr(obj, f.name) for f in dataclasses.fields(cls)
            if f.name not in ("parent", "name")}


@pytest.mark.parametrize("config", list(CONFIGS))
def test_full_config_matches_jax(config):
    """Each port config's model arguments (its defaults where the config is
    silent), criterion and eval bounds equal the JAX config's."""
    port = Config("relation_detr_tpu_torch/configs/" + CONFIGS[config])
    ref = JConfig("configs/" + CONFIGS[config])
    signature = inspect.signature(RelationDETR.__init__).parameters
    effective = {k: v.default for k, v in signature.items()
                 if v.default is not inspect.Parameter.empty}
    effective.update(port.model_args)
    for key, want in _fields(ref.model, JRelationDETR).items():
        if key in signature:
            assert effective[key] == want, key
        else:
            assert want == JRelationDETR.__dataclass_fields__[key].default, key
    assert dataclasses.asdict(port.build_criterion()) == dataclasses.asdict(ref.criterion)
    for key in ("min_size", "max_size", "select_box_nums_for_evaluation", "hybrid_assign"):
        assert port.get(key) == ref.get(key), key
    assert inspect.signature(port.build_model).parameters["device"].default == "cuda"


def test_build_backbone_routes_and_raises():
    """``build_backbone`` takes every Swin, ConvNeXt, FocalNet, ViT and
    EVA-02 arch of the JAX tables (on ``meta``, no compute) with JAX's
    ``num_channels``, and a ResNet with ``stage_with_dcn`` (its DCN convs
    where the flags say); an unknown arch of a family raises ValueError."""
    families = ((jswin, backbones.SwinTransformerBackbone),
                (jconvnext, backbones.ConvNeXtBackbone),
                (jfocalnet, backbones.FocalNetBackbone),
                (jvit, backbones.VisionTransformerBackbone))
    for jmod, cls in families:
        for arch in jmod.ARCH_SETTINGS:
            with torch.device("meta"):
                model = backbones.build_backbone(arch)
            assert isinstance(model, cls)
            assert model.num_channels == jbackbones.build_backbone(arch).num_channels, arch
    for arch in ("swin_xxl", "vit_base", "eva_02_vit_large", "no_such_arch"):
        with pytest.raises(ValueError):
            backbones.build_backbone(arch)
    flags = (False, False, True, True)
    with torch.device("meta"):
        model = backbones.build_backbone("resnet50", stage_with_dcn=flags)
    assert model.num_channels == jbackbones.build_backbone(
        "resnet50", stage_with_dcn=flags).num_channels
    for stage, dcn in enumerate(flags):
        for block in getattr(model, f"layer{stage + 1}"):
            assert isinstance(block.conv2, DeformConv2dPack) == dcn, (stage, block)
