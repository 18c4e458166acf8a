"""The port's remaining bricks against the JAX package, on the same numpy
inputs: the bilinear point sampler and the DCN over it (alone, in a tiny DCN
ResNet and in its detector), NMS and the post-processing that calls it, the
segmentation decode, the learned position embedding, SqueezeExcitation and
ContextBlock, and the weight-name registry.

Weights are JAX-initialised and perturbed (zero-initialised offsets, masks
and last layers would hide a layout bug) and carried across by
``state_dict_from_jax``, or the port's, carried to JAX by ``jax_weights``.
Outputs within 1e-4 of each output's max |x|, gradients within 1e-3 of each
leaf's max, the tiny detector's heads before the two-stage top-k at 2e-3,
keep masks and class maps exactly. The JAX side runs jitted; torch runs on
one thread.
"""
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, ".")
from tools.convert_torch_weights import convert_state_dict  # noqa: E402

from relation_detr_tpu.models import layers as jlayers  # noqa: E402
from relation_detr_tpu.models import post_process as jpost  # noqa: E402
from relation_detr_tpu.models.backbones import resnet as jresnet  # noqa: E402
from relation_detr_tpu.models.deform_conv import DeformConv2dPack as JDeformConv  # noqa: E402
from relation_detr_tpu.models.detector import RelationDETR as JRelationDETR  # noqa: E402
from relation_detr_tpu.models.position_encoding import (  # noqa: E402
    PositionEmbeddingLearned as JPositionEmbeddingLearned,
)
from relation_detr_tpu.ops import grid_sample as jgrid  # noqa: E402
from relation_detr_tpu.ops import nms as jnms  # noqa: E402
from relation_detr_tpu.utils import weight_registry as jregistry  # noqa: E402
from relation_detr_tpu_torch.models import backbones, layers, post_process  # noqa: E402
from relation_detr_tpu_torch.models.deform_conv import DeformConv2dPack  # noqa: E402
from relation_detr_tpu_torch.models.detector import RelationDETR  # noqa: E402
from relation_detr_tpu_torch.models.position_encoding import PositionEmbeddingLearned  # noqa: E402
from relation_detr_tpu_torch.ops import grid_sample, nms  # noqa: E402
from relation_detr_tpu_torch.utils import weight_registry  # noqa: E402
from relation_detr_tpu_torch.utils.param_groups import build_optimizer  # noqa: E402
from relation_detr_tpu_torch.utils.weights import (  # noqa: E402
    jax_key_label,
    jax_weights,
    state_dict_from_jax,
)
from tests.test_torch_backbones import (  # noqa: E402
    TINY,
    TOL_GRAD,
    TOL_HEADS,
    TOL_OUT,
    _batch,
    _jax_param_shapes,
    _shapes,
    _t,
)
from tests.test_torch_families import _quick_jit  # noqa: E402
from tests.test_torch_modules import flatten, perturb, strip, unflatten  # noqa: E402

DCN_STAGES = (False, True, True, True)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _close(got, want, tol, label):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (label, got.shape, want.shape)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=tol * float(np.abs(want).max()) + 1e-12, err_msg=label)


def _module_pair(jmodule, tmodule, params, inputs, rng, prefix="m", nchw=False):
    """Output and the gradients (parameters and float inputs) of sum(out *
    cotangent) on both sides, the port loaded with ``params`` through the
    bridge; ``inputs`` NHWC, as JAX takes them (``nchw``: the port module
    takes and returns NCHW). Returns ((JAX out, port out), [(JAX grad, port
    grad, label)])."""
    out = jax.eval_shape(lambda p, *x: jmodule.apply({"params": p}, *x), params,
                         *map(jnp.asarray, inputs))
    cot = rng.randn(*out.shape).astype(np.float32)
    floats = [i for i, x in enumerate(inputs) if np.asarray(x).dtype == np.float32]

    def loss(p, *x):
        y = jmodule.apply({"params": p}, *x)
        return jnp.sum(y * cot), y

    (_, jout), jgrads = _quick_jit(jax.value_and_grad(loss, argnums=(0, *[1 + i for i in floats]),
                                                      has_aux=True))(
        params, *map(jnp.asarray, inputs))
    sd = state_dict_from_jax({f"{prefix}/{k}": v for k, v in flatten(params).items()}, {})
    tmodule.load_state_dict(strip(sd, f"{prefix}."))
    tin = [_t(x).requires_grad_(i in floats) for i, x in enumerate(inputs)]
    if nchw:
        tout = tmodule(*(t.permute(0, 3, 1, 2) for t in tin)).permute(0, 2, 3, 1)
    else:
        tout = tmodule(*tin)
    (tout * _t(cot)).sum().backward()
    jparam = strip(state_dict_from_jax({f"{prefix}/{k}": v for k, v in
                                        flatten(jgrads[0]).items()}, {}), f"{prefix}.")
    pairs = [(jparam[n].numpy(), p.grad.numpy(), n) for n, p in tmodule.named_parameters()]
    assert sorted(n for *_, n in pairs) == sorted(jparam)
    pairs += [(np.asarray(g), tin[i].grad.numpy(), f"input {i}")
              for i, g in zip(floats, jgrads[1:])]
    return (jout, tout.detach().numpy()), pairs


def _check_pair(result, label):
    (jout, tout), grads = result
    _close(tout, jout, TOL_OUT, f"{label} output")
    for want, got, name in grads:
        assert np.isfinite(got).all(), (label, name)
        _close(got, want, TOL_GRAD, f"{label} grad {name}")


def test_bilinear_sample_matches_jax():
    """Points on integers, fractional, and off the map on each side (one,
    two, three or four corners outside): samples and the gradients of the map
    and the points, as JAX's."""
    rng = np.random.RandomState(0)
    feat = rng.randn(2, 5, 7, 3).astype(np.float32)
    pts = np.concatenate([
        rng.uniform(-1.5, 7.5, (2, 40, 1)),
        rng.uniform(-1.5, 5.5, (2, 40, 1))], -1)
    pts[:, :8] = np.floor(pts[:, :8])  # on integers
    pts[:, 8:12] = [[-0.5, 2.3], [6.5, 1.2], [3.3, -0.7], [2.1, 4.4]]  # each side, half out
    pts[:, 12:16] = [[-1.0, 2.0], [7.0, 1.0], [3.0, -1.0], [2.0, 5.0]]  # just past each side
    pts[:, 16:18] = [[-3.0, -3.0], [9.0, 8.0]]  # far off
    pts = pts.astype(np.float32)
    cot = rng.randn(2, 40, 3).astype(np.float32)

    def loss(f, p):
        out = jgrid.bilinear_sample(f, p)
        return jnp.sum(out * cot), out

    (_, want), (gf, gp) = jax.jit(jax.value_and_grad(loss, (0, 1), has_aux=True))(feat, pts)
    tf, tp = _t(feat).requires_grad_(True), _t(pts).requires_grad_(True)
    got = grid_sample.bilinear_sample(tf, tp)
    (got * _t(cot)).sum().backward()
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(tf.grad.numpy(), gf, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(tp.grad.numpy(), gp, rtol=1e-5, atol=1e-5)
    assert not got[:, 16:18].any()


@pytest.mark.parametrize("groups,stride", [(1, 1), (2, 1), (1, 2), (2, 2)])
def test_deform_conv_matches_jax(groups, stride):
    """``DeformConv2dPack`` with perturbed offsets (a few pixels: fractional
    samples, some off the map) and masks, with a bias: output and the
    gradients of every parameter and the input."""
    rng = np.random.RandomState(groups * 10 + stride)
    x = rng.randn(2, 9, 11, 8).astype(np.float32)
    jconv = JDeformConv(features=6, kernel_size=3, stride=stride, groups=groups)
    params = flatten(jconv.init(jax.random.key(1), jnp.asarray(x))["params"])
    params = perturb(params, rng, 0.1)
    params["conv_offset/kernel"] = rng.randn(3, 3, 8, 18).astype(np.float32) * 0.5
    params["conv_offset/bias"] = rng.randn(18).astype(np.float32) * 2.0
    tconv = DeformConv2dPack(8, 6, 3, stride, groups)
    result = _module_pair(jconv, tconv, unflatten(params), [x], rng, nchw=True)
    offsets = tconv.conv_offset(_t(x).permute(0, 3, 1, 2))
    assert offsets.abs().max() > 3.0  # some samples leave the map
    _check_pair(result, f"DCN groups {groups} stride {stride}")


def test_dcn_resnet_matches_jax():
    """A DCN ResNet-18 (layer2-4 deformable) on
    perturbed JAX-initialised weights with offsets of a few pixels: the three
    stage outputs, and the gradients of every trainable parameter (the
    DCN's offsets and masks among them; the stem and layer1 frozen)."""
    rng = np.random.RandomState(3)
    x = rng.randn(1, 64, 96, 3).astype(np.float32)
    jbb = jresnet.ResNetBackbone(arch="resnet18", stage_with_dcn=DCN_STAGES)
    variables = _quick_jit(lambda k: jbb.init(k, jnp.asarray(x)))(
        jax.random.key(0, impl="unsafe_rbg"))
    params = perturb(flatten(variables["params"]), rng, 0.02)
    for key in params:
        if "conv_offset" in key:
            params[key] = rng.randn(*params[key].shape).astype(np.float32) * (
                0.02 if key.endswith("kernel") else 1.0)
    stats = perturb(flatten(variables["batch_stats"]), rng, 0.05)
    outs = jax.eval_shape(lambda p: jbb.apply({"params": p, "batch_stats": unflatten(stats)},
                                              jnp.asarray(x)), unflatten(params))
    cots = [rng.randn(*o.shape).astype(np.float32) for o in outs]

    def loss(p):
        outs = jbb.apply({"params": p, "batch_stats": unflatten(stats)}, jnp.asarray(x))
        return sum(jnp.sum(o * c) for o, c in zip(outs, cots)), outs

    (_, jouts), jgrads = _quick_jit(jax.value_and_grad(loss, has_aux=True))(unflatten(params))
    model = backbones.build_backbone("resnet18", stage_with_dcn=DCN_STAGES)
    assert isinstance(model.layer2[0].conv2, DeformConv2dPack)
    assert not isinstance(model.layer1[0].conv2, DeformConv2dPack)
    sd = state_dict_from_jax({f"backbone/{k}": v for k, v in params.items()},
                             {f"backbone/{k}": v for k, v in stats.items()})
    model.load_state_dict(strip(sd, "backbone."))
    touts = model(_t(x).permute(0, 3, 1, 2))
    sum((o.permute(0, 2, 3, 1) * _t(c)).sum() for o, c in zip(touts, cots)).backward()
    for i, (got, want) in enumerate(zip(touts, jouts)):
        _close(got.detach().permute(0, 2, 3, 1).numpy(), want, TOL_OUT, f"stage {i}")
    jg = strip(state_dict_from_jax({f"backbone/{k}": v for k, v in flatten(jgrads).items()},
                                   {}), "backbone.")
    trainable = {n: p for n, p in model.named_parameters() if p.requires_grad}
    assert all(n.startswith(("layer2", "layer3", "layer4")) for n in trainable)
    assert any("conv_offset" in n for n in trainable)
    for name, param in trainable.items():
        _close(param.grad.numpy(), jg[name].numpy(), TOL_GRAD, name)
    assert model.layer2[0].conv2.conv_offset.weight.grad.abs().max() > 0


@pytest.fixture(scope="module")
def dcn_detector():
    """A tiny detector on the DCN ResNet-18 on each side, the port's seeded
    weights (perturbed, offsets of about a pixel) carried to JAX by
    ``jax_weights``: the eval forward with the encoder's heads before the
    two-stage top-k."""
    rng = np.random.RandomState(11)
    args = dict(TINY, backbone_arch="resnet18", backbone_stage_with_dcn=DCN_STAGES)
    model = RelationDETR(**args, generator=torch.Generator().manual_seed(0))
    sd = {k: v.numpy() for k, v in model.state_dict().items()}
    sd = perturb(sd, rng, 0.02)
    for key in sd:
        if "conv_offset" in key:
            sd[key] = sd[key] * (1.0 if key.endswith("weight") else 50.0)
    model.load_state_dict({k: _t(v) for k, v in sd.items()})
    arrays = jax_weights(model)
    images, mask = _batch(rng)
    jmodel = JRelationDETR(**args)
    names = ("encoder_class_head", "encoder_bbox_head")
    variables = {c: unflatten({k[len(c) + 1:]: v for k, v in arrays.items()
                               if k.startswith(c + "/")}) for c in ("params", "batch_stats")}
    jout, inter = _quick_jit(lambda v, x, m: jmodel.apply(
        v, x, m, train=False, capture_intermediates=lambda mdl, _: mdl.name in names,
        mutable=["intermediates"]))(variables, jnp.asarray(images), jnp.asarray(mask))
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


def test_dcn_detector_heads_match_jax(dcn_detector):
    run = dcn_detector
    for name, want in run["jpre"].items():
        np.testing.assert_allclose(run["tpre"][name], want, rtol=TOL_HEADS, atol=TOL_HEADS,
                                   err_msg=f"{name} before the top-k")
    for key in ("pred_logits", "pred_boxes"):
        got, want = run["tout"][key].numpy(), np.asarray(run["jout"][key])
        assert got.shape == want.shape and np.isfinite(got).all(), key
        np.testing.assert_allclose(got, want, rtol=TOL_HEADS, atol=TOL_HEADS, err_msg=key)


def test_dcn_weight_bridge(dcn_detector):
    """``jax_weights`` of the DCN detector gives exactly the JAX model's
    trees (the (9, C, O) tap kernels among them), ``state_dict_from_jax``
    every tensor back bit for bit, and ``convert_state_dict`` reads the
    port's state_dict with nothing left over and gives the same arrays."""
    run = dcn_detector
    arrays, sd = run["arrays"], run["model"].state_dict()
    for collection in ("params", "batch_stats"):
        assert {k[len(collection) + 1:]: tuple(v.shape) for k, v in arrays.items()
                if k.startswith(collection + "/")} == run["jax_shapes"][collection]
    assert arrays["params/backbone/layer2_0/conv2/kernel"].shape == (9, 128, 128)
    params = {k[len("params/"):]: v for k, v in arrays.items() if k.startswith("params/")}
    stats = {k[len("batch_stats/"):]: v for k, v in arrays.items()
             if k.startswith("batch_stats/")}
    back = state_dict_from_jax(params, stats)
    assert sorted(back) == sorted(sd)
    for k, v in sd.items():
        assert torch.equal(back[k], v), k
    got_params, got_stats, leftover = convert_state_dict(dict(sd))
    assert not leftover, leftover[:8]
    assert sorted(got_params) == sorted(params) and sorted(got_stats) == sorted(stats)
    for k, v in got_params.items():
        np.testing.assert_array_equal(v, params[k], err_msg=k)


def test_r50_dcn_params_match_jax():
    """The DCN ResNet-50 (layer2-4 deformable), the port built on ``meta``,
    has the JAX backbone's parameters and FrozenBN statistics through the
    bridge's names and layouts, and nothing else; the DCN convs hold 3x3
    kernels and 18 + 9 offset and mask channels, layer2's first at stride 2."""
    with torch.device("meta"):
        holder = torch.nn.Module()
        holder.backbone = backbones.build_backbone("resnet50", stage_with_dcn=DCN_STAGES)
    sd = {k: tuple(v.shape) for k, v in holder.state_dict().items()}
    jbb = jresnet.ResNetBackbone(arch="resnet50", stage_with_dcn=DCN_STAGES)
    tree = jax.eval_shape(lambda: jbb.init(jax.random.key(0), jnp.zeros((1, 64, 96, 3))))
    want = {}
    for collection in ("params", "batch_stats"):
        for key, shape in _shapes(tree[collection]).items():
            name = jax_key_label(f"{collection}/backbone/{key}")
            if key.endswith("kernel") and len(shape) == 4:
                shape = (shape[3], shape[2], shape[0], shape[1])
            elif key.endswith("kernel"):  # the DCN's taps
                shape = (shape[2], shape[1], 3, 3)
            want[name] = shape
    assert want == sd
    assert holder.backbone.layer2[0].conv2.stride == 2  # the bottleneck's stride is on its 3x3
    assert sd["backbone.layer3.0.conv2.conv_offset.weight"] == (18, 256, 3, 3)
    assert sd["backbone.layer4.2.conv2.conv_mask.weight"] == (9, 512, 3, 3)


def test_dcn_stays_fp32_under_bf16():
    """Under the bf16 policy the DCN ResNet's plain convs compute in bf16
    while each DCN is fed fp32 (the FrozenBN before it promotes), computes
    in fp32 and has no compute dtype, as the JAX module has none; its
    offsets and masks of layer2-4 train and the optimizer holds them."""
    rng = np.random.RandomState(5)
    images, mask = _batch(rng)
    model = RelationDETR(**TINY, backbone_arch="resnet18", backbone_stage_with_dcn=DCN_STAGES,
                         backbone_dtype="bfloat16", compute_dtype="bfloat16",
                         generator=torch.Generator().manual_seed(0))
    dcns = [m for m in model.backbone.modules() if isinstance(m, DeformConv2dPack)]
    assert len(dcns) == 6
    assert model.backbone.layer2[0].conv1.compute_dtype == torch.bfloat16
    seen = []
    hooks = [m.register_forward_hook(lambda mod, a, out: seen.append((a[0].dtype, out.dtype)))
             for m in dcns]
    hooks += [m.conv_offset.register_forward_hook(
        lambda mod, a, out: seen.append((a[0].dtype, out.dtype))) for m in dcns]
    conv_dtypes = []
    hooks.append(model.backbone.layer2[0].conv1.register_forward_hook(
        lambda mod, a, out: conv_dtypes.append(out.dtype)))
    with torch.no_grad():
        model(_t(images), _t(mask))
    for hook in hooks:
        hook.remove()
    assert seen == [(torch.float32, torch.float32)] * 12
    assert conv_dtypes == [torch.bfloat16]
    for dcn in dcns:
        assert not any(hasattr(m, "compute_dtype") for m in dcn.modules())
    held = {id(p) for g in build_optimizer(model, 1e-4).param_groups for p in g["params"]}
    for dcn in dcns:
        assert all(p.requires_grad and id(p) in held for p in dcn.parameters())


def _nms_case(rng, b, n):
    """Integer boxes in a small field (many overlaps, IoUs that are exact
    fractions) and scores from few values (ties)."""
    xy = rng.randint(0, 12, (b, n, 2))
    wh = rng.randint(1, 8, (b, n, 2))
    boxes = np.concatenate([xy, xy + wh], -1).astype(np.float32)
    scores = rng.randint(0, 6, (b, n)).astype(np.float32) / 5.0
    return boxes, scores


def test_nms_mask_equals_jax():
    """Keep masks exactly JAX's (vmapped over B=2), at thresholds where
    IoUs land exactly on them, with tied scores (the stable sort); and a
    hand case: IoU exactly 0.5 at threshold 0.5 keeps both (strict >)."""
    rng = np.random.RandomState(0)
    boxes, scores = _nms_case(rng, 2, 60)
    for thr in (0.5, 0.25, 0.7, 1.0 / 3.0):
        want = np.asarray(jax.jit(jax.vmap(lambda b, s: jnms.nms_mask(b, s, thr)))(
            boxes, scores))
        got = nms.nms_mask(_t(boxes), _t(scores), thr).numpy()
        np.testing.assert_array_equal(got, want, err_msg=f"threshold {thr}")
        assert 0 < got.sum() < got.size
        for i in range(2):
            np.testing.assert_array_equal(nms.nms_mask(_t(boxes[i]), _t(scores[i]), thr), want[i])
    edge = np.array([[0, 0, 2, 1], [0, 0, 1, 1], [0, 0, 2, 1], [5, 5, 6, 6]], np.float32)
    edge_scores = np.array([0.9, 0.8, 0.8, 0.8], np.float32)
    for thr in (0.5, 0.49):
        want = np.asarray(jnms.nms_mask(jnp.asarray(edge), jnp.asarray(edge_scores), thr))
        got = nms.nms_mask(_t(edge), _t(edge_scores), thr).numpy()
        np.testing.assert_array_equal(got, want)
    assert got.tolist() == [True, False, False, True]


def test_post_process_nms_equals_jax():
    """``post_process`` with ``nms_iou_threshold`` (and without, and with a
    confidence cut) against JAX's at B=2: top-k scores, labels and boxes
    close, the valid masks exactly equal. No two top-k scores tie here:
    ``torch.topk`` orders tied entries otherwise than ``lax.top_k`` (ROADMAP,
    standing differences); ``test_nms_mask_equals_jax`` holds NMS on ties."""
    rng = np.random.RandomState(1)
    logits = rng.randn(2, 40, 5).astype(np.float32)
    centres = rng.uniform(0.3, 0.7, (2, 40, 2))
    boxes = np.concatenate([centres, rng.uniform(0.1, 0.5, (2, 40, 2))], -1).astype(np.float32)
    sizes = np.array([[480, 640], [600, 400]], np.float32)
    for kwargs in (dict(nms_iou_threshold=0.5), dict(nms_iou_threshold=0.7, confidence_score=0.3),
                   dict()):
        want = jpost.post_process(jnp.asarray(logits), jnp.asarray(boxes), jnp.asarray(sizes),
                                  100, **kwargs)
        got = post_process.post_process(_t(logits), _t(boxes), _t(sizes), 100, **kwargs)
        np.testing.assert_array_equal(got["valid"].numpy(), np.asarray(want["valid"]))
        np.testing.assert_array_equal(got["labels"].numpy(), np.asarray(want["labels"]))
        np.testing.assert_allclose(got["scores"].numpy(), want["scores"], rtol=1e-6)
        np.testing.assert_allclose(got["boxes"].numpy(), want["boxes"], rtol=1e-5, atol=1e-3)
        if kwargs:
            assert 0 < got["valid"].sum() < got["valid"].numel()


@pytest.mark.parametrize("target_hw", [(24, 40), (5, 7), (16, 6)],
                         ids=["upsize", "downsize", "up_and_down"])
def test_segmentation_post_process_equals_jax(target_hw):
    """The class map after the per-class mean, a bilinear resize (the
    kernel widened where the map shrinks) and the argmax, exactly JAX's."""
    rng = np.random.RandomState(2)
    logits = rng.randn(2, 12, 6).astype(np.float32)
    masks = (rng.randn(2, 12, 12, 14) * 3).astype(np.float32)
    want = np.asarray(jpost.segmentation_post_process(jnp.asarray(logits), jnp.asarray(masks),
                                                      target_hw))
    got = post_process.segmentation_post_process(_t(logits), _t(masks), target_hw).numpy()
    assert got.shape == (2, *target_hw)
    np.testing.assert_array_equal(got, want)


def test_position_embedding_learned_equals_jax():
    """[col(x), row(y)] on perturbed tables, inside the tables and with h
    and w past them (the index clamped to the last entry, as JAX's gather
    clamps it)."""
    rng = np.random.RandomState(3)
    jpe = JPositionEmbeddingLearned(num_embeddings=6, num_pos_feats=4)
    mask = np.zeros((2, 5, 4), bool)
    params = perturb(flatten(jpe.init(jax.random.key(0), jnp.asarray(mask))["params"]), rng, 0.1)
    pe = PositionEmbeddingLearned(6, 4)
    pe.load_state_dict(state_dict_from_jax(params, {}))
    for hw in ((5, 4), (8, 9)):
        mask = np.zeros((2, *hw), bool)
        want = np.asarray(jpe.apply({"params": unflatten(params)}, jnp.asarray(mask)))
        got = pe(_t(mask)).detach().numpy()
        np.testing.assert_array_equal(got, want, err_msg=str(hw))
    np.testing.assert_array_equal(got[0, 7, 8, 4:], params["row_embed"][5])
    holder = torch.nn.Module()
    holder.pe = pe
    assert {k: v.shape for k, v in jax_weights(holder).items()} == \
        {"params/pe/row_embed": (6, 4), "params/pe/col_embed": (6, 4)}


def test_squeeze_excitation_equals_jax():
    rng = np.random.RandomState(4)
    x = rng.randn(2, 5, 6, 32).astype(np.float32)
    jse = jlayers.SqueezeExcitation(channels=32, reduction=8)
    params = perturb(flatten(jse.init(jax.random.key(0), jnp.asarray(x))["params"]), rng, 0.1)
    se = layers.SqueezeExcitation(32, 8)
    _check_pair(_module_pair(jse, se, unflatten(params), [x], rng), "SqueezeExcitation")


@pytest.mark.parametrize("pooling", ["attn", "avg"])
@pytest.mark.parametrize("fusions", [("channel_add",), ("channel_mul",),
                                     ("channel_add", "channel_mul")])
def test_context_block_equals_jax(pooling, fusions):
    """Both poolings and every fusion subset, on perturbed weights (the
    zero-initialised last layers made non-zero)."""
    rng = np.random.RandomState(5)
    x = rng.randn(2, 5, 6, 32).astype(np.float32)
    jcb = jlayers.ContextBlock(channels=32, ratio=0.25, pooling_type=pooling,
                               fusion_types=fusions)
    params = perturb(flatten(jcb.init(jax.random.key(0), jnp.asarray(x))["params"]), rng, 0.1)
    cb = layers.ContextBlock(32, 0.25, pooling, fusions)
    layers.init_weights(cb, torch.Generator().manual_seed(0))
    assert all(not getattr(cb, f"{f}_2").weight.any() for f in fusions)
    outs, grads = _module_pair(jcb, cb, unflatten(params), [x], rng)
    if pooling == "attn":
        # the softmax over positions ignores a shift: the conv_mask bias's
        # gradient is 0, and both sides give rounding noise far below the
        # conv_mask weight's gradient
        (want, got, _), = [g for g in grads if g[2] == "conv_mask.bias"]
        scale = np.abs([g for g in grads if g[2] == "conv_mask.weight"][0][0]).max()
        assert max(np.abs(want).max(), np.abs(got).max()) < 1e-4 * scale
        grads = [g for g in grads if g[2] != "conv_mask.bias"]
    _check_pair((outs, grads), f"{pooling} {fusions}")
    with pytest.raises(ValueError):
        layers.ContextBlock(32, pooling_type="max")


def test_weight_registry_equals_jax(tmp_path, monkeypatch):
    """The same tables; in a ``tmp_path`` cache each name resolves to the
    same file as the JAX registry's (a path, ``<key>.npz``, the arch's
    default key, the URL's stem), and both raise alike."""
    assert weight_registry.WEIGHT_URLS == jregistry.WEIGHT_URLS
    assert weight_registry.DEFAULT_ARCH_WEIGHTS == jregistry.DEFAULT_ARCH_WEIGHTS
    home = tmp_path / "home"
    cache = tmp_path / "cache"
    cache.mkdir()
    monkeypatch.setenv("HOME", str(home))
    monkeypatch.setenv("RELATION_DETR_WEIGHTS_DIR", str(cache))
    assert weight_registry.cache_dirs() == jregistry.cache_dirs()
    (cache / "resnet50_v2.npz").write_bytes(b"x")
    (cache / "swin_tiny_patch4_window7_224.npz").write_bytes(b"x")
    plain = tmp_path / "w.npz"
    plain.write_bytes(b"x")
    for name in ("resnet50", "resnet50_v2", "swin_t_in1k", str(plain)):
        assert weight_registry.resolve_pretrained(name) == jregistry.resolve_pretrained(name)
        assert weight_registry.lookup_url(name) == jregistry.lookup_url(name)
    assert weight_registry.resolve_pretrained("resnet50") == str(cache / "resnet50_v2.npz")
    with pytest.raises(FileNotFoundError, match="swin_l_in22k"):
        weight_registry.resolve_pretrained("swin_l")
    with pytest.raises(KeyError):
        weight_registry.resolve_pretrained("no_such_weights")
