"""The port's bf16 policy against the JAX package's, on the CPU.

The JAX modules built with ``dtype=bfloat16`` (``backbone_dtype`` /
``compute_dtype`` on the detector) against the port's modules under the
same compute dtype, with the same (perturbed) weights carried across by the
weight bridge: module by module (the linear, MHA, the MSDA module, an
encoder layer, a decoder layer, the encoder with its memory fusion, the
ResNet-18 backbone), the MSDA op on a bf16 value, the dtype at every island
boundary, and the tiny-test config's eval forward and train step.

Tolerances are in bf16 units: ``EPS`` is bf16's unit roundoff (2^-8), and a
tolerance of n units of a tensor is n * EPS * max |JAX tensor|. The port
and JAX round at the same places but one: flax rounds a Dense's product to
bf16 and then adds the bias in bf16, ``F.linear`` adds the bias before its
one rounding (``test_linear_matches_flax_dense``), and the two sum their
fp32 accumulators in different orders, so a rounding flips now and then
and the flips grow with depth. The JAX side runs jitted, its inits too. torch runs on one thread: beside other test
processes, its thread pool slows tenfold.
"""
import importlib
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as nn

sys.path.insert(0, ".")
from tools.convert_torch_weights import convert_state_dict  # noqa: E402

from relation_detr_tpu.losses import criterion as jcrit  # noqa: E402
from relation_detr_tpu.models import attention as jattention  # noqa: E402
from relation_detr_tpu.models.attention import MultiheadAttention as JMHA  # noqa: E402
from relation_detr_tpu.models.attention import (  # noqa: E402
    MultiScaleDeformableAttention as JMSDA,
)
from relation_detr_tpu.models.backbones.resnet import ResNetBackbone as JResNet  # noqa: E402
from relation_detr_tpu.models.detector import RelationDETR as JRelationDETR  # noqa: E402
from relation_detr_tpu.models.transformer import (  # noqa: E402
    RelationTransformerEncoder as JEncoder,
)
from relation_detr_tpu.models.transformer import (  # noqa: E402
    TransformerDecoderLayer as JDecoderLayer,
)
from relation_detr_tpu.models.transformer import (  # noqa: E402
    TransformerEncoderLayer as JEncoderLayer,
)
from relation_detr_tpu.ops.msda import msda_defaults as j_msda_defaults  # noqa: E402
from relation_detr_tpu.ops.msda import multi_scale_deformable_attention as j_msda  # noqa: E402
from relation_detr_tpu_torch.losses import criterion as tcrit  # noqa: E402
from relation_detr_tpu_torch.models import attention as tattention  # noqa: E402
from relation_detr_tpu_torch.models.attention import (  # noqa: E402
    MultiheadAttention,
    MultiScaleDeformableAttention,
)
from relation_detr_tpu_torch.models.backbones import build_backbone  # noqa: E402
from relation_detr_tpu_torch.models.detector import RelationDETR  # noqa: E402
from relation_detr_tpu_torch.models.layers import Linear, set_compute_dtype  # noqa: E402
from relation_detr_tpu_torch.models.transformer import (  # noqa: E402
    RelationTransformerEncoder,
    TransformerDecoderLayer,
    TransformerEncoderLayer,
)
from relation_detr_tpu_torch.ops.msda import multi_scale_deformable_attention  # noqa: E402
from relation_detr_tpu_torch.utils.weights import _module_path, state_dict_from_jax  # noqa: E402
from tests.test_torch_modules import flatten, perturb, strip, unflatten  # noqa: E402
from tests.test_torch_train import _cdn_draws, _jax_train_loss, _targets  # noqa: E402

TINY = importlib.import_module(
    "relation_detr_tpu_torch.configs.relation_detr.relation_detr_resnet50_tiny_test")
BF16 = torch.bfloat16
EPS = 2.0 ** -8  # bf16's unit roundoff
LEVELS = ((10, 12), (5, 6), (3, 3), (2, 2))
C, HEADS = 256, 8  # the tiny config's widths


@pytest.fixture(autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _np(t):
    return t.detach().float().numpy()


def _close_in_units(got, want, units, what):
    """|got - want| <= units * EPS * max |want|, elementwise."""
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape, what
    assert np.isfinite(got).all() and np.isfinite(want).all(), what
    scale = float(np.abs(want).max())
    err = float(np.abs(got - want).max())
    assert err <= units * EPS * scale, (
        f"{what}: max |diff| {err:.4g} = {err / (EPS * scale):.2f} bf16 units of max "
        f"{scale:.4g}, allowed {units}")


def _port_weights(jmodule, args, rng, prefix, scale=0.05):
    """The JAX module's initial parameters, perturbed, as JAX variables and
    as the port's state_dict (keys under ``prefix`` stripped)."""
    params = jax.jit(lambda key: jmodule.init(key, *args))(jax.random.key(0))["params"]
    flat = perturb(flatten(params, prefix + "/"), rng, scale)
    sd = strip(state_dict_from_jax(flat, {}), prefix + ".")
    return {"params": unflatten(strip(flat, prefix + "/"))}, sd


# ---------------------------------------------------------------------------
# module level
# ---------------------------------------------------------------------------

def test_linear_matches_flax_dense():
    """The port's ``Linear`` under bf16 against flax ``nn.Dense(dtype=bf16)``:
    bf16 out. The product rounded and the bias added in bf16 (flax's order)
    equals flax but where the two fp32 sums, taken in different orders,
    round apart (under 0.1% of the elements, by one rounding), so the
    port's one difference is ``F.linear``'s fused bias: |port - flax| <=
    EPS * (|x W| + 2 |y|), one rounding of the product and one of each sum
    (about a third of the elements differ by one unit in the last place)."""
    rng = np.random.RandomState(0)
    x = rng.randn(64, C).astype(np.float32)
    dense = nn.Dense(2048, dtype=jnp.bfloat16)
    variables = {"params": {"kernel": jnp.asarray(rng.randn(C, 2048).astype(np.float32) / 16),
                            "bias": jnp.asarray(rng.randn(2048).astype(np.float32))}}
    want = np.asarray(jax.jit(dense.apply)(variables, x).astype(jnp.float32))
    layer = Linear(C, 2048)
    layer.load_state_dict(strip(state_dict_from_jax(flatten(variables["params"], "fc/"), {}),
                                "fc."))
    set_compute_dtype(layer, BF16)
    xt = torch.from_numpy(x)
    with torch.no_grad():
        got = layer(xt)
        product = torch.nn.functional.linear(xt.to(BF16), layer.weight.to(BF16))
        flax_order = (product + layer.bias.to(BF16)).float().numpy()
        exact = (xt.to(BF16).float() @ layer.weight.to(BF16).float().T).numpy()
    assert got.dtype == BF16
    bound = EPS * (np.abs(exact) + 2 * np.abs(want))
    assert (flax_order != want).mean() < 1e-3
    assert (np.abs(flax_order - want) <= bound).all()
    got = got.float().numpy()
    assert (np.abs(got - want) <= bound).all()
    assert 0 < (got != want).mean() < 0.5


def test_mha_matches_jax_bf16():
    """Dense MHA with an additive fp32 bias (-1e9 where blocked): q, k, v
    and out_proj in bf16, fp32 logits and softmax; the bf16 output within 2
    bf16 units of its max."""
    rng = np.random.RandomState(1)
    q = rng.randn(2, 30, C).astype(np.float32)
    v = rng.randn(2, 30, C).astype(np.float32)
    bias = (rng.randn(2, HEADS, 30, 30) * 2).astype(np.float32)
    bias[:, :, :5, 25:] = -1e9
    jm = JMHA(C, HEADS, dtype=jnp.bfloat16)
    args = (q, q, v, bias)
    variables, sd = _port_weights(jm, args, rng, "self_attn")
    want = np.asarray(jax.jit(jm.apply)(variables, *args))
    tm = MultiheadAttention(C, HEADS)
    tm.load_state_dict(sd, strict=True)
    set_compute_dtype(tm, BF16)
    with torch.no_grad():
        got = tm(*(torch.from_numpy(a) for a in args))
    assert want.dtype == jnp.bfloat16 and got.dtype == BF16
    _close_in_units(_np(got), want, 2, "MHA out")


@pytest.mark.parametrize("ref_dim", [2, 4])
def test_msda_module_matches_jax_bf16(ref_dim):
    """The MSDA module: bf16 value projection (padding rows zeroed in bf16),
    offsets and weights rounded to bf16 then fp32 locations and softmax, the
    core on the bf16 value, bf16 output projection: within 4 bf16 units
    (measured 3.1 and 2.3: each of the four projections' fused bias moves a
    rounding, and a moved offset moves its sample)."""
    rng = np.random.RandomState(ref_dim)
    total = sum(h * w for h, w in LEVELS)
    query = rng.randn(2, 40, C).astype(np.float32)
    value = rng.randn(2, total, C).astype(np.float32)
    ref = rng.uniform(0.05, 0.95, (2, 40, len(LEVELS), ref_dim)).astype(np.float32)
    mask = np.zeros((2, total), bool)
    mask[1, 100:] = True
    jm = JMSDA(C, len(LEVELS), HEADS, 4, dtype=jnp.bfloat16)
    variables, sd = _port_weights(jm, (query, ref, value, LEVELS, mask), rng, "attn")
    want = np.asarray(jax.jit(lambda v, *a: jm.apply(v, a[0], a[1], a[2], LEVELS, a[3]))(
        variables, query, ref, value, mask))
    tm = MultiScaleDeformableAttention(C, len(LEVELS), HEADS, 4)
    tm.load_state_dict(sd, strict=True)
    set_compute_dtype(tm, BF16)
    with torch.no_grad():
        got = tm(torch.from_numpy(query), torch.from_numpy(ref), torch.from_numpy(value),
                 LEVELS, torch.from_numpy(mask))
    assert want.dtype == jnp.bfloat16 and got.dtype == BF16
    _close_in_units(_np(got), want, 4, "MSDA module out")


def _encoder_inputs(rng, bs=2):
    total = sum(h * w for h, w in LEVELS)
    query = rng.randn(bs, total, C).astype(np.float32)
    pos = rng.randn(bs, total, C).astype(np.float32)
    ref = rng.uniform(0.05, 0.95, (bs, total, len(LEVELS), 2)).astype(np.float32)
    mask = np.zeros((bs, total), bool)
    mask[1, 150:] = True
    return query, pos, ref, mask


def test_encoder_layer_matches_jax_bf16():
    """An encoder layer (MSDA + FFN in bf16, residual adds and LayerNorms
    fp32): the fp32 output within 4 bf16 units of its max."""
    rng = np.random.RandomState(3)
    query, pos, ref, mask = _encoder_inputs(rng)
    jm = JEncoderLayer(LEVELS, dtype=jnp.bfloat16)
    variables, sd = _port_weights(jm, (query, pos, ref, mask), rng, "layer")
    want = np.asarray(jax.jit(jm.apply)(variables, query, pos, ref, mask))
    tm = TransformerEncoderLayer()
    tm.load_state_dict(sd, strict=True)
    set_compute_dtype(tm, BF16)
    with torch.no_grad():
        got = tm(*(torch.from_numpy(a) for a in (query, pos, ref)), LEVELS,
                 torch.from_numpy(mask))
    assert want.dtype == np.float32 and got.dtype == torch.float32
    _close_in_units(got.numpy(), want, 4, "encoder layer out")


def test_encoder_with_memory_fusion_matches_jax_bf16():
    """The encoder (one layer) and its memory fusion: both fusion linears in
    bf16, the fusion's LayerNorm on their output as fp32: within 4 bf16
    units."""
    rng = np.random.RandomState(4)
    query, pos, ref, mask = _encoder_inputs(rng)
    jm = JEncoder(num_layers=1, remat=False, dtype=jnp.bfloat16)
    args = (query, pos, ref, LEVELS, mask)
    variables, sd = _port_weights(jm, args, rng, "encoder")
    want = np.asarray(jax.jit(lambda v, q, p, r, m: jm.apply(v, q, p, r, LEVELS, m))(
        variables, query, pos, ref, mask))
    tm = RelationTransformerEncoder(num_layers=1)
    tm.load_state_dict(sd, strict=True)
    set_compute_dtype(tm, BF16)
    with torch.no_grad():
        got = tm(*(torch.from_numpy(a) for a in (query, pos, ref)), LEVELS,
                 torch.from_numpy(mask))
    assert want.dtype == np.float32 and got.dtype == torch.float32
    _close_in_units(got.numpy(), want, 4, "encoder + memory fusion out")


def test_decoder_layer_matches_jax_bf16():
    """A decoder layer (MHA with an fp32 bias, MSDA cross-attention, FFN in
    bf16; adds and LayerNorms fp32): within 4 bf16 units."""
    rng = np.random.RandomState(5)
    total = sum(h * w for h, w in LEVELS)
    query = rng.randn(2, 40, C).astype(np.float32)
    pos = rng.randn(2, 40, C).astype(np.float32)
    ref = rng.uniform(0.1, 0.9, (2, 40, len(LEVELS), 4)).astype(np.float32)
    memory = rng.randn(2, total, C).astype(np.float32)
    mask = np.zeros((2, total), bool)
    mask[0, 120:] = True
    bias = (rng.randn(2, HEADS, 40, 40)).astype(np.float32)
    jm = JDecoderLayer(dtype=jnp.bfloat16)
    variables, sd = _port_weights(
        jm, (query, pos, ref, memory, LEVELS, mask, bias), rng, "layer")
    want = np.asarray(jax.jit(lambda v, q, p, r, x, m, b: jm.apply(v, q, p, r, x, LEVELS, m, b))(
        variables, query, pos, ref, memory, mask, bias))
    tm = TransformerDecoderLayer()
    tm.load_state_dict(sd, strict=True)
    set_compute_dtype(tm, BF16)
    with torch.no_grad():
        got = tm(*(torch.from_numpy(a) for a in (query, pos, ref, memory)), LEVELS,
                 torch.from_numpy(mask), torch.from_numpy(bias))
    assert want.dtype == np.float32 and got.dtype == torch.float32
    _close_in_units(got.numpy(), want, 4, "decoder layer out")


def test_resnet18_backbone_matches_jax_bf16():
    """ResNet-18 under ``backbone_dtype`` bf16: bf16 convolutions, FrozenBN
    promoting to fp32, casts after bn1 and every block, fp32 stage outputs:
    each within 4 bf16 units of its max."""
    rng = np.random.RandomState(6)
    x = rng.randn(2, 64, 96, 3).astype(np.float32)
    jbb = JResNet(arch="resnet18", dtype=jnp.bfloat16)
    init = jax.jit(jbb.init)(jax.random.key(0), x)
    params = perturb(flatten(init["params"], "backbone/"), rng, 0.02)
    stats = perturb(flatten(init["batch_stats"], "backbone/"), rng, 0.1)
    want = jax.jit(jbb.apply)({"params": unflatten(strip(params, "backbone/")),
                               "batch_stats": unflatten(strip(stats, "backbone/"))}, x)
    backbone = build_backbone("resnet18")
    backbone.load_state_dict(strip(state_dict_from_jax(params, stats), "backbone."),
                             strict=True)
    set_compute_dtype(backbone, BF16)
    with torch.no_grad():
        got = backbone(torch.from_numpy(x).permute(0, 3, 1, 2))
    assert len(got) == len(want) == 3
    for i, (g, w) in enumerate(zip(got, want)):
        assert g.dtype == torch.float32 and w.dtype == jnp.float32
        _close_in_units(g.permute(0, 2, 3, 1).numpy(), np.asarray(w), 4, f"stage {i + 1}")


def test_msda_op_bf16_value_matches_jax_gather():
    """A bf16 value through ``multi_scale_deformable_attention`` (the CPU's
    plain version) against the JAX gather: the bf16 output within one bf16
    rounding of JAX's (elementwise, EPS of each element plus fp32 noise),
    and ``grad_value`` comes back bf16, within one rounding of JAX's vjp."""
    rng = np.random.RandomState(7)
    total = sum(h * w for h, w in LEVELS)
    value = rng.randn(2, total, HEADS, 32).astype(np.float32)
    value = np.asarray(jnp.asarray(value, jnp.bfloat16).astype(jnp.float32))
    locs = rng.uniform(-0.1, 1.1, (2, 50, HEADS, len(LEVELS), 4, 2)).astype(np.float32)
    attn = rng.rand(2, 50, HEADS, len(LEVELS), 4).astype(np.float32)
    grad = rng.randn(2, 50, HEADS * 32).astype(np.float32)
    jv = jnp.asarray(value, jnp.bfloat16)

    def jfun(v):
        return j_msda(v, LEVELS, jnp.asarray(locs), jnp.asarray(attn), impl="gather")

    want, vjp = jax.vjp(jfun, jv)
    (want_grad,) = vjp(jnp.asarray(grad, jnp.bfloat16))
    tv = torch.from_numpy(value).to(BF16).requires_grad_(True)
    got = multi_scale_deformable_attention(tv, LEVELS, torch.from_numpy(locs),
                                           torch.from_numpy(attn))
    got.backward(torch.from_numpy(grad).to(BF16))
    assert got.dtype == BF16 and want.dtype == jnp.bfloat16
    assert tv.grad.dtype == BF16 and want_grad.dtype == jnp.bfloat16
    for g, w, what in ((_np(got), want, "out"), (_np(tv.grad), want_grad, "grad_value")):
        w = np.asarray(w.astype(jnp.float32))
        assert (np.abs(g - w) <= EPS * np.abs(w) + 1e-6 * np.abs(w).max()).all(), what


# ---------------------------------------------------------------------------
# the tiny-test config: dtype map, eval forward, train step
# ---------------------------------------------------------------------------

# The JAX decoder's default route (``decoder_prepack``) projects the memory
# once into corner tables in fp32 and samples them in fp32; the port, like
# JAX's gather and its corner_pack without the prepack, projects each
# layer's value in bf16 (the bf16 island ISSUE's trace names, ROADMAP Queue
# 3). The JAX side of the detector tests runs without the prepack.
NO_PREPACK = dict(decoder_prepack=False)
B, H, W = 2, 128, 160
BF16_ARGS = dict(backbone_dtype="bfloat16", compute_dtype="bfloat16")
# the tiny config's depth with tests/test_model_families.py's bf16 case's
# queries and classes (the class of its head checks is set at 30 queries)
MODEL_ARGS = dict(TINY.model_args, num_classes=10, num_queries=30, hybrid_num_proposals=40,
                  denoising_nums=4)
CRITERION_ARGS = dict(num_classes=10)


def _batch(rng):
    images = rng.randn(B, H, W, 3).astype(np.float32)
    mask = np.zeros((B, H, W), bool)
    mask[1, 96:] = True
    mask[1, :, 112:] = True
    images[mask] = 0.0
    return images, mask


@pytest.fixture(scope="module")
def tiny_pair():
    """The port model under the bf16 policy (seeded weights, perturbed) and
    the JAX model under it with the same weights."""
    model = RelationDETR(**MODEL_ARGS, **BF16_ARGS,
                         generator=torch.Generator().manual_seed(0)).eval()
    rng = np.random.RandomState(17)
    sd = {k: v.numpy() for k, v in model.state_dict().items()}
    noisy = perturb({k: v for k, v in sd.items()
                     if not k.startswith("backbone.") or "bn" in k or "downsample.1" in k},
                    rng, 0.02)
    model.load_state_dict({k: torch.from_numpy(v) for k, v in {**sd, **noisy}.items()})
    params, stats, leftover = convert_state_dict(dict(model.state_dict()))
    assert not leftover, leftover[:8]
    variables = {"params": unflatten(params), "batch_stats": unflatten(stats)}
    return dict(model=model, jmodel=JRelationDETR(**MODEL_ARGS, **BF16_ARGS),
                variables=variables, params=params, stats=stats, rng=rng)


def _jax_dtypes(jmodel, variables, images, mask, monkeypatch):
    """Output dtype of every JAX module call (port module names), the MSDA
    core's value / locations / weights / output dtypes, from an abstract
    trace of the eval forward."""
    core = []

    def recording(value, shapes, locs, weights, *a, **k):
        out = j_msda(value, shapes, locs, weights, *a, **k)
        core.append((value.dtype, locs.dtype, weights.dtype, out.dtype))
        return out

    monkeypatch.setattr(jattention, "multi_scale_deformable_attention", recording)
    with j_msda_defaults(**NO_PREPACK):
        _, inter = jax.eval_shape(lambda v: jmodel.apply(
            v, images, mask, train=False, capture_intermediates=True,
            mutable=["intermediates"]), variables)
    found = {}

    def walk(tree, path):
        for k, v in tree.items():
            if k == "__call__":
                out = v[0]
                if hasattr(out, "dtype") and path:
                    found[_module_path(path)] = np.dtype(out.dtype)
                elif isinstance(out, tuple) and path == ["backbone"]:
                    found["backbone"] = tuple(np.dtype(o.dtype) for o in out)
            elif isinstance(v, dict):
                walk(v, path + [k])

    walk(inter["intermediates"], [])
    return found, core


def _port_dtypes(model, images, mask, monkeypatch):
    found, core, logits = {}, [], []
    hooks = [model.transformer.decoder.position_relation_embedding.register_forward_pre_hook(
        lambda mod, args: found.__setitem__("relation boxes", tuple(a.dtype for a in args)))]
    for name, module in model.named_modules():
        def hook(mod, args, out, name=name):
            if isinstance(out, torch.Tensor):
                found[name] = out.dtype
            elif name == "backbone":
                found[name] = tuple(o.dtype for o in out)
        hooks.append(module.register_forward_hook(hook))
    real_core, real_logits = multi_scale_deformable_attention, tattention.attention_logits

    def recording(value, shapes, locs, weights):
        out = real_core(value, shapes, locs, weights)
        core.append((value.dtype, locs.dtype, weights.dtype, out.dtype))
        return out

    def recording_logits(q, k):
        out = real_logits(q, k)
        logits.append((q.dtype, out.dtype))
        return out

    monkeypatch.setattr(tattention, "multi_scale_deformable_attention", recording)
    monkeypatch.setattr(tattention, "attention_logits", recording_logits)
    try:
        with torch.no_grad():
            out = model(torch.from_numpy(images), torch.from_numpy(mask))
    finally:
        for h in hooks:
            h.remove()
    return found, core, logits, out


TORCH_OF = {np.dtype(jnp.bfloat16): torch.bfloat16, np.dtype(np.float32): torch.float32}


def test_dtype_map_matches_jax(tiny_pair, monkeypatch):
    """The dtype at every island boundary equals JAX's: each backbone conv
    (bf16) and FrozenBN (fp32), the stage outputs (fp32), the neck, every
    Dense / Linear (bf16 inside the layers and the fusion, fp32 heads,
    ref_point_head, query_scale, enc_output), every LayerNorm (fp32), the
    relation bias (fp32); the MSDA core's value (bf16), locations and
    weights (fp32) and output (bf16); the MHA logits fp32 from bf16 q, k
    (read from the JAX MHA's jaxpr); the relation embedding's boxes fp32;
    the heads fp32."""
    images, mask = _batch(np.random.RandomState(2))
    jfound, jcore = _jax_dtypes(tiny_pair["jmodel"], tiny_pair["variables"], images, mask,
                                monkeypatch)
    tfound, tcore, tlogits, out = _port_dtypes(tiny_pair["model"], images, mask, monkeypatch)
    compared = []
    for name, jd in jfound.items():
        if name not in tfound:
            continue
        want = tuple(TORCH_OF[d] for d in jd) if isinstance(jd, tuple) else TORCH_OF[jd]
        assert tfound[name] == want, (name, tfound[name], want)
        compared.append(name)
    must = ["backbone", "backbone.conv1", "backbone.bn1", "backbone.layer4.1.conv2",
            "neck.convs.0", "transformer.encoder.layers.0.self_attn.sampling_offsets",
            "transformer.encoder.layers.0.norm1", "transformer.encoder.layers.0.linear2",
            "transformer.encoder.memory_fusion.0", "transformer.encoder.memory_fusion.3",
            "transformer.decoder.layers.1.self_attn.out_proj",
            "transformer.decoder.layers.1.cross_attn.output_proj",
            "transformer.decoder.layers.1.norm3", "transformer.decoder.ref_point_head",
            "transformer.decoder.query_scale", "transformer.decoder.class_head.1",
            "transformer.decoder.position_relation_embedding", "transformer.enc_output",
            "transformer.enc_output_norm", "transformer.encoder_class_head"]
    assert not [n for n in must if n not in compared], [n for n in must if n not in compared]
    assert tfound["transformer.encoder.layers.0.self_attn.value_proj"] == BF16
    assert tfound["transformer.decoder.position_relation_embedding"] == torch.float32
    assert tfound["relation boxes"] == (torch.float32, torch.float32)
    assert len(tcore) == len(jcore) == 3  # 1 encoder + 2 decoder layers
    assert tcore == [(TORCH_OF[np.dtype(a)],) + tuple(TORCH_OF[np.dtype(x)] for x in r)
                     for a, *r in jcore]
    assert tcore[0] == (BF16, torch.float32, torch.float32, BF16)

    jm = JMHA(C, HEADS, dtype=jnp.bfloat16)
    x = jnp.zeros((1, 5, C))
    jaxpr = jax.make_jaxpr(lambda: jm.init_with_output(jax.random.key(0), x, x, x,
                                                       jnp.zeros((1, HEADS, 5, 5))))()
    dots = [e for e in jaxpr.jaxpr.eqns if e.primitive.name == "dot_general"
            and e.outvars[0].aval.shape == (1, HEADS, 5, 5)]
    assert [(d.invars[0].aval.dtype, d.outvars[0].aval.dtype) for d in dots] == \
        [(jnp.bfloat16, jnp.float32)]
    assert tlogits == [(BF16, torch.float32)] * 2  # one MHA per decoder layer
    for key in ("pred_logits", "pred_boxes"):
        assert out[key].dtype == torch.float32
        assert out["enc_outputs"][key].dtype == torch.float32


@pytest.fixture(scope="module")
def tiny_forward(tiny_pair):
    """The eval forward on both sides, with the encoder's class head and box
    head outputs before the two-stage top-k."""
    images, mask = _batch(np.random.RandomState(2))
    jmodel = tiny_pair["jmodel"]
    names = ("encoder_class_head", "encoder_bbox_head")
    apply = jax.jit(lambda v, x, m: jmodel.apply(
        v, x, m, train=False, capture_intermediates=lambda mdl, _: mdl.name in names,
        mutable=["intermediates"]))
    with j_msda_defaults(**NO_PREPACK):
        jout, inter = apply(tiny_pair["variables"], images, mask)
    jpre = {n: np.asarray(inter["intermediates"]["transformer"][n]["__call__"][0])
            for n in names}
    model, tpre = tiny_pair["model"], {}
    hooks = [getattr(model.transformer, n).register_forward_hook(
        lambda mod, a, out, n=n: tpre.__setitem__(n, out.numpy())) for n in names]
    try:
        with torch.no_grad():
            tout = model(torch.from_numpy(images), torch.from_numpy(mask))
    finally:
        for h in hooks:
            h.remove()
    return dict(jout=jout, tout=tout, jpre=jpre, tpre=tpre)


def test_eval_forward_before_topk_matches_jax_bf16(tiny_forward):
    """The encoder's class logits and box head over every token, before the
    top-k (whose order any rounding can change): within 6 bf16 units of
    their max (a backbone, an encoder layer and the fusion deep; measured
    1.8 and 3.6)."""
    for name, want in tiny_forward["jpre"].items():
        _close_in_units(tiny_forward["tpre"][name], want, 6, name)


def test_eval_heads_match_jax_bf16(tiny_forward):
    """The decoder's heads, in the class of tests/test_model_families.py's
    bf16 checks: median |dlogit| < 0.05, the sorted top-50 logits within
    0.3, each image's boxes as sets median < 0.02; fp32 and finite."""
    jout, tout = tiny_forward["jout"], tiny_forward["tout"]
    lt, lj = tout["pred_logits"].numpy(), np.asarray(jout["pred_logits"])
    assert tout["pred_logits"].dtype == torch.float32 and np.isfinite(lt).all()
    assert np.median(np.abs(lt - lj)) < 0.05
    np.testing.assert_allclose(np.sort(lt.reshape(-1))[-50:], np.sort(lj.reshape(-1))[-50:],
                               atol=0.3)
    for b in range(B):
        bt, bj = tout["pred_boxes"][b].numpy(), np.asarray(jout["pred_boxes"])[b]
        d = np.abs(bt[:, None, :] - bj[None, :, :]).max(-1)
        assert float(np.median(d.min(1))) < 0.02


@pytest.fixture(scope="module")
def tiny_train(tiny_pair):
    """One train forward + backward under the bf16 policy on both sides,
    same weights, batch and CDN draws."""
    rng = np.random.RandomState(23)
    images, mask = _batch(rng)
    labels, boxes, valid = _targets(rng, (4, 2), 6, CRITERION_ARGS["num_classes"], scatter=True)
    model = tiny_pair["model"]
    draws = _cdn_draws(rng, B, model.denoising_generator.dn_cap, CRITERION_ARGS["num_classes"])
    jcfg = jcrit.CriterionConfig(**CRITERION_ARGS)
    with j_msda_defaults(**NO_PREPACK):
        (jtotal, (jlosses, _, _)), _ = _jax_train_loss(
            tiny_pair["jmodel"], jcfg, TINY.hybrid_assign)(
            unflatten(tiny_pair["params"]), unflatten(tiny_pair["stats"]),
            jnp.asarray(images), jnp.asarray(mask), jnp.asarray(labels, jnp.int32),
            jnp.asarray(boxes), jnp.asarray(valid), {k: jnp.asarray(v) for k, v in draws.items()})
    model.train()
    model.zero_grad(set_to_none=True)
    try:
        t = [torch.from_numpy(a) for a in (images, mask, labels, boxes, valid)]
        outputs = model(*t, train=True, noise_draws={k: torch.from_numpy(v)
                                                    for k, v in draws.items()})
        total, losses = tcrit.relation_detr_loss(tcrit.CriterionConfig(**CRITERION_ARGS),
                                                 outputs, t[2], t[3], t[4], TINY.hybrid_assign)
        total.backward()
        grads = {n: p.grad.clone() for n, p in model.named_parameters() if p.grad is not None}
    finally:
        model.eval()
        model.zero_grad(set_to_none=True)
    return dict(jtotal=float(jtotal), jlosses={k: float(v) for k, v in jlosses.items()},
                total=total.item(), losses={k: v.item() for k, v in losses.items()},
                grads=grads)


TOL_TOTAL = 0.01  # relative: the weighted total (measured 0.23%)
TOL_ENC = 0.01  # relative: the encoder's terms (measured at most 0.29%)
# the decoder's terms follow the two-stage top-k, which the bf16 rounding of
# the encoder's output reorders on either side (70 of 120 top-60 slots in
# the tiny config differ, 0 under fp32): measured at most 5.4% relative
# (loss_class_0), and 12% on the smallest term (2.4e-4 absolute)
TOL_DECODER, ATOL_DECODER = 0.1, 1e-3


def test_train_losses_match_jax_bf16(tiny_train):
    """Every loss term of the bf16 train forward against JAX bf16: the
    total and the encoder's terms within 1% relative, the decoder's within
    10% relative or 1e-3 absolute."""
    p = tiny_train
    assert sorted(p["losses"]) == sorted(p["jlosses"])
    for k, want in p["jlosses"].items():
        assert np.isfinite(p["losses"][k]), k
        rtol, atol = (TOL_ENC, 0.0) if "_enc" in k else (TOL_DECODER, ATOL_DECODER)
        np.testing.assert_allclose(p["losses"][k], want, rtol=rtol, atol=atol, err_msg=k)
    np.testing.assert_allclose(p["total"], p["jtotal"], rtol=TOL_TOTAL)


def test_train_grads_fp32_finite_and_state_dict_unchanged(tiny_train, tiny_pair):
    """Every trainable parameter gets an fp32, finite gradient (the frozen
    stem and layer1 none), and the bf16 model's state_dict has the fp32
    model's keys, shapes and dtypes (the policy is compute-only)."""
    model = tiny_pair["model"]
    trainable = {n for n, p in model.named_parameters() if p.requires_grad}
    assert set(tiny_train["grads"]) == trainable
    for name, g in tiny_train["grads"].items():
        assert g.dtype == torch.float32 and torch.isfinite(g).all(), name
    fp32 = RelationDETR(**MODEL_ARGS, generator=torch.Generator().manual_seed(0))
    want = {k: (v.shape, v.dtype) for k, v in fp32.state_dict().items()}
    assert {k: (v.shape, v.dtype) for k, v in model.state_dict().items()} == want
    assert all(v.dtype == torch.float32 for v in model.state_dict().values())
