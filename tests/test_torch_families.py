"""The port's model families against the JAX package, on the same numpy inputs.

DINO++, Deformable-DETR++, DN-Def-DETR++ and DAB-Def-DETR++ with the
switches of ``tests/test_model_families.py`` at a tiny size (ResNet-18,
embed 64, 1 encoder and 2 decoder layers, 30 queries): the port's seeded
weights (perturbed) carried to the JAX model by
``tools/convert_torch_weights.py::convert_state_dict``, the eval heads, the
train losses with the same denoising draws (injected into the JAX generator
through ``flax.linen.intercept_methods``) and the gradients against
``jax.grad``. Then the DN generator alone, the criterion's
``two_stage_binary_cls`` and ``mixed_match``, a decoder without the
relation bias, dropout, the port's family configs against the JAX ones and
the weight bridge of the families' parameters. The JAX side runs jitted;
torch runs on one thread.
"""
import dataclasses
import importlib
import inspect
import math
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
from relation_detr_tpu.models.denoising import (  # noqa: E402
    GenerateDenoisingQueries as JGenerator,
)
from relation_detr_tpu.models.detector import RelationDETR as JRelationDETR  # noqa: E402
from relation_detr_tpu.models.transformer import (  # noqa: E402
    RelationTransformerDecoder as JDecoder,
)
from relation_detr_tpu.utils.config import Config as JConfig  # noqa: E402
from relation_detr_tpu_torch.losses import criterion as tcrit  # noqa: E402
from relation_detr_tpu_torch.models import layers  # noqa: E402
from relation_detr_tpu_torch.models.denoising import GenerateDNQueries  # noqa: E402
from relation_detr_tpu_torch.models.detector import RelationDETR  # noqa: E402
from relation_detr_tpu_torch.models.transformer import (  # noqa: E402
    RelationTransformer,
    RelationTransformerDecoder,
)
from relation_detr_tpu_torch.utils.config import Config  # noqa: E402
from relation_detr_tpu_torch.utils.weights import (  # noqa: E402
    jax_weights,
    state_dict_from_jax,
)
from tests.test_model_families import FAMILIES  # noqa: E402
from tests.test_torch_modules import flatten, perturb, unflatten  # noqa: E402
from tests.test_torch_train import _cdn_draws, _targets  # noqa: E402

FAMILY_NAMES = ("dino_pp", "def_detr_pp", "dn_def_detr_pp", "dab_def_detr_pp")
NUM_CLASSES = 10
TINY = dict(num_classes=NUM_CLASSES, embed_dim=64, dim_feedforward=128, num_heads=8,
            num_queries=30, hybrid_num_proposals=40, denoising_nums=4,
            transformer_enc_layers=1, transformer_dec_layers=2, backbone_arch="resnet18")
B, H, W = 2, 96, 128
GT_COUNTS, GT_CAP = (3, 2), 5
TOL_HEADS = 2e-3
TOL_LOSS = 1e-4  # relative, every loss term
TOL_GRAD = 1e-3  # of each leaf's max |grad|
# the port's family configs and the JAX configs they copy
CONFIGS = {
    "dino_pp": "dino_pp/dino_pp_resnet50_800_1333.py",
    "def_detr_pp": "deformable_detr_pp/def_detr_pp_resnet50_800_1333.py",
    "dn_def_detr_pp": "dn_def_detr_pp/dn_def_detr_pp_resnet50_800_1333.py",
    "dab_def_detr_pp": "dab_def_detr_pp/dab_def_detr_pp_resnet50_800_1333.py",
    "sa_det": "relation_detr/relation_detr_resnet50_sa_det_100k.py",
}


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _t(x):
    return torch.from_numpy(np.array(x))


def _criterion_args(family):
    return dict(num_classes=NUM_CLASSES, class_loss_type="focal",
                two_stage_binary_cls=family == "def_detr_pp")


def _dn_draws(rng, bs, dn_cap):
    return {"flip_u": rng.rand(bs, dn_cap).astype(np.float32),
            "random_labels": rng.randint(0, NUM_CLASSES, (bs, dn_cap)),
            "noise_u": rng.rand(bs, dn_cap, 4).astype(np.float32)}


def _jax_family_run(jmodel, cfg):
    """jit of the eval apply (with the encoder top-k indices) and
    jit(value_and_grad) of the train loss with injected denoising draws."""

    def topk_of(inter):
        return [out[:2] for out in
                inter["intermediates"].get("transformer", {}).get("_select_topk", ())]

    def eval_fn(variables, images, mask):
        out, inter = jmodel.apply(variables, images, mask, train=False,
                                  capture_intermediates=lambda m, n: n == "_select_topk",
                                  mutable=["intermediates"])
        return out, topk_of(inter)

    def loss_fn(params, stats, images, mask, labels, boxes, valid, draws):
        def inject(next_fun, args, kwargs, context):
            if isinstance(context.module, JGenerator) and context.method_name == "__call__":
                kwargs = {**kwargs, "noise_draws": draws}
            return next_fun(*args, **kwargs)

        with nn.intercept_methods(inject):
            outputs, inter = jmodel.apply(
                {"params": params, "batch_stats": stats}, images, mask, labels, boxes, valid,
                train=True, rngs={"denoising": jax.random.key(0)},
                capture_intermediates=lambda m, n: n == "_select_topk",
                mutable=["intermediates"])
        total, losses = jcrit.relation_detr_loss(cfg, outputs, labels, boxes, valid)
        heads = (outputs["pred_logits"], outputs["pred_boxes"])
        return total, (losses, topk_of(inter), heads)

    return _quick_jit(eval_fn), _quick_jit(jax.value_and_grad(loss_fn, has_aux=True))


# LLVM's optimisation passes take most of XLA:CPU's compile time for these
# one-call programs; without them a result can move by a rounding at most.
QUICK_COMPILE = {"xla_backend_optimization_level": 0, "xla_llvm_disable_expensive_passes": True}


def _quick_jit(fn):
    """jit compiled with ``QUICK_COMPILE``, called once."""
    return lambda *args: jax.jit(fn).lower(*args).compile(QUICK_COMPILE)(*args)


def _jax_param_shapes(jmodel, images, mask):
    tree = jax.eval_shape(lambda: jmodel.init(
        {"params": jax.random.key(0), "denoising": jax.random.key(1)},
        jnp.asarray(images), jnp.asarray(mask), jnp.zeros((B, 4), jnp.int32),
        jnp.full((B, 4, 4), 0.5), jnp.zeros((B, 4), bool), train=True))
    return {name: {"/".join(str(getattr(k, "key", k)) for k in path): tuple(leaf.shape)
                   for path, leaf in jax.tree_util.tree_flatten_with_path(tree[name])[0]}
            for name in ("params", "batch_stats")}


@pytest.fixture(scope="module", params=FAMILY_NAMES)
def family(request):
    """One tiny model of the family on each side, same (perturbed) weights:
    the eval forward, and one train forward + backward with the same batch
    and denoising draws."""
    name = request.param
    settings = {**TINY, **FAMILIES[name]}
    model = RelationDETR(**settings, generator=torch.Generator().manual_seed(0))
    rng = np.random.RandomState(41)
    sd = {k: v.numpy() for k, v in model.state_dict().items()}
    noisy = perturb({k: v for k, v in sd.items()
                     if not k.startswith("backbone.") or "bn" in k or "downsample.1" in k},
                    rng, 0.02)
    model.load_state_dict({k: torch.from_numpy(v) for k, v in {**sd, **noisy}.items()})
    params, stats, leftover = convert_state_dict(dict(model.state_dict()))
    assert not leftover, leftover[:8]

    images = rng.randn(B, H, W, 3).astype(np.float32)
    mask = np.zeros((B, H, W), bool)
    mask[1, 72:] = True
    mask[1, :, 96:] = True
    images[mask] = 0.0
    labels, boxes, valid = _targets(rng, GT_COUNTS, GT_CAP, NUM_CLASSES, scatter=True)
    gen = model.denoising_generator
    draws = None
    if gen is not None:
        draws = (_cdn_draws(rng, B, gen.dn_cap, NUM_CLASSES) if gen.contrastive
                 else _dn_draws(rng, B, gen.dn_cap))

    jmodel = JRelationDETR(**settings)
    jcfg = jcrit.CriterionConfig(**_criterion_args(name))
    jeval, jtrain = _jax_family_run(jmodel, jcfg)
    variables = {"params": unflatten(params), "batch_stats": unflatten(stats)}
    jout, jtopk_eval = jeval(variables, jnp.asarray(images), jnp.asarray(mask))
    (jtotal, (jlosses, jtopk, jheads)), jgrads = jtrain(
        variables["params"], variables["batch_stats"], jnp.asarray(images), jnp.asarray(mask),
        jnp.asarray(labels, jnp.int32), jnp.asarray(boxes), jnp.asarray(valid),
        None if draws is None else {k: jnp.asarray(v) for k, v in draws.items()})

    topk = []
    select = RelationTransformer._select_topk

    def recording_select(*args):
        out = select(*args)
        topk.append([t.detach().numpy().copy() for t in out[:2]])
        return out

    RelationTransformer._select_topk = staticmethod(recording_select)
    try:
        with torch.no_grad():
            tout = model.eval()(_t(images), _t(mask))
        topk_eval, topk = topk, []
        model.train()
        outputs = model(_t(images), _t(mask), _t(labels), _t(boxes), _t(valid), train=True,
                        noise_draws=None if draws is None else
                        {k: _t(v) for k, v in draws.items()})
    finally:
        RelationTransformer._select_topk = staticmethod(select)
    ttotal, tlosses = tcrit.relation_detr_loss(tcrit.CriterionConfig(**_criterion_args(name)),
                                               outputs, _t(labels), _t(boxes), _t(valid))
    ttotal.backward()
    return dict(name=name, model=model, params=params, stats=stats, jout=jout, tout=tout,
                topk_eval=(topk_eval, jtopk_eval), topk=(topk, jtopk), jtotal=jtotal,
                jlosses=jlosses, jheads=jheads, jgrads=flatten(jgrads), outputs=outputs,
                ttotal=ttotal, tlosses=tlosses, labels=labels, boxes=boxes, valid=valid,
                jax_shapes=_jax_param_shapes(jmodel, images, mask))


def _same_topk(pair):
    """The encoder top-k selected the same proposals as JAX: their class
    logits and boxes. (Padded and invalid proposals share one score and one
    box, so the two may take other members of such a tie; that changes no
    output. A tie flipped between valid proposals would change every one
    after it.)"""
    got, want = pair
    assert len(got) == len(want)
    for g, w in zip(got, want):
        for what, a, b in zip(("class logits", "boxes"), g, w):
            np.testing.assert_allclose(a, np.asarray(b), rtol=TOL_HEADS, atol=TOL_HEADS,
                                       err_msg=f"the top-k selected other {what} than JAX")


def test_family_params_match_jax(family):
    """The port's state_dict holds exactly the JAX model's parameters (names
    and shapes): no memory fusion, the encoder heads only when two-stage,
    ``tgt_embed`` / ``refpoint_embed`` per query source, the indicator-wide
    DN label encoder."""
    for name, flat in (("params", family["params"]), ("batch_stats", family["stats"])):
        want = family["jax_shapes"][name]
        got = {k: tuple(v.shape) for k, v in flat.items()}
        assert want == got, sorted(set(want) ^ set(got))[:8]
    sd = family["model"].state_dict()
    assert not any(".memory_fusion." in k for k in sd)
    assert ("transformer.enc_output.weight" in sd) == (family["name"] != "dn_def_detr_pp")
    assert ("transformer.refpoint_embed.weight" in sd) == (family["name"] == "dn_def_detr_pp")
    assert ("transformer.tgt_embed.weight" in sd) == (family["name"] != "dab_def_detr_pp")


def test_family_eval_heads_match_jax(family):
    """The eval forward: every decoder layer's heads and, when two-stage,
    the encoder top-k's (``enc_outputs``), same top-k indices, at 2e-3."""
    _same_topk(family["topk_eval"])
    jout, tout = family["jout"], family["tout"]
    assert set(tout) == set(jout)
    assert ("enc_outputs" in tout) == (family["name"] != "dn_def_detr_pp")
    pairs = [(k, tout[k], jout[k]) for k in ("pred_logits", "pred_boxes")]
    pairs += [(f"{s}/{k}", tout[s][k], jout[s][k]) for s in ("aux_outputs", "enc_outputs")
              if s in tout for k in ("pred_logits", "pred_boxes")]
    for label, got, want in pairs:
        got, want = got.numpy(), np.asarray(want)
        assert got.shape == want.shape, label
        assert np.isfinite(got).all(), label
        np.testing.assert_allclose(got, want, rtol=TOL_HEADS, atol=TOL_HEADS, err_msg=label)


def test_family_train_losses_match_jax(family):
    """Every loss term and the weighted total of the train forward (with
    the denoising terms where the family has them): rtol 1e-4."""
    _same_topk(family["topk"])
    got, want = family["tlosses"], family["jlosses"]
    assert sorted(got) == sorted(want)
    assert any(k.endswith("_dn") for k in got) == (family["name"] in ("dino_pp",
                                                                      "dn_def_detr_pp"))
    assert any(k.endswith("_enc") for k in got) == (family["name"] != "dn_def_detr_pp")
    assert not any(k.endswith("_hybrid") for k in got)
    weights = tcrit.build_weight_dict(tcrit.CriterionConfig(num_classes=NUM_CLASSES), 2,
                                      "dn_outputs" in family["outputs"], False)
    assert set(got) <= set(weights)
    for k, w in want.items():
        v = got[k].item()
        assert math.isfinite(v), k
        np.testing.assert_allclose(v, float(w), rtol=TOL_LOSS, atol=1e-7, err_msg=k)
    np.testing.assert_allclose(family["ttotal"].item(), float(family["jtotal"]), rtol=TOL_LOSS)


def test_family_train_grads_match_jax(family):
    """Every trainable parameter's gradient against jax.grad, within 1e-3 of
    the leaf's max |grad|."""
    _same_topk(family["topk"])
    want = state_dict_from_jax(family["jgrads"], {})
    checked = 0
    for name, param in family["model"].named_parameters():
        if not param.requires_grad:
            continue
        w = want[name].numpy()
        assert param.grad is not None, name
        np.testing.assert_allclose(param.grad.numpy(), w, rtol=0,
                                   atol=TOL_GRAD * float(np.abs(w).max()) + 1e-12,
                                   err_msg=name)
        checked += 1
    assert checked > 80


def test_family_weight_bridge_round_trip(family):
    """port -> ``jax_weights`` equals ``convert_state_dict``'s arrays
    (``refpoint_embed``, the indicator-wide label encoder, no memory
    fusion), and ``state_dict_from_jax`` gives every tensor back."""
    model = family["model"]
    arrays = jax_weights(model)
    want = {**{f"params/{k}": v for k, v in family["params"].items()},
            **{f"batch_stats/{k}": v for k, v in family["stats"].items()}}
    assert sorted(arrays) == sorted(want)
    for k, v in want.items():
        np.testing.assert_array_equal(arrays[k], v, err_msg=k)
    back = state_dict_from_jax(
        {k[len("params/"):]: v for k, v in arrays.items() if k.startswith("params/")},
        {k[len("batch_stats/"):]: v for k, v in arrays.items() if k.startswith("batch_stats/")})
    sd = model.state_dict()
    assert sorted(back) == sorted(sd)
    for k, v in sd.items():
        assert torch.equal(back[k], v), k


@pytest.mark.parametrize("gt_counts,cap,groups", [((3, 1), 5, 3), ((2, 5, 4), 7, 5),
                                                  ((0, 0), 3, 5), ((25,), 30, 5)],
                         ids=["two_images", "three_images", "empty", "crowded"])
def test_dn_generator_matches_jax(gt_counts, cap, groups):
    """``GenerateDNQueries`` against the JAX generator with DN settings
    (label noise 0.2, box noise 0.4, indicator) and the same injected draws:
    queries atol 1e-5, the bias and every DenoisingMeta field exact.
    ``crowded``: 25 boxes at a capacity of 10 a group (dn_cap 50) leave
    dn_cap // max_gt = 2 < 5 groups, so the group cut runs."""
    rng = np.random.RandomState(sum(gt_counts) + cap)
    labels, boxes, valid = _targets(rng, gt_counts, cap, NUM_CLASSES)
    max_gt_cap_dn = 10 if gt_counts == (25,) else 60
    jgen = JGenerator(num_classes=NUM_CLASSES, embed_dim=16, contrastive=False,
                      denoising_groups=groups, max_gt_cap_dn=max_gt_cap_dn,
                      label_noise_prob=0.2, box_noise_scale=0.4, with_indicator=True)
    args = (jnp.asarray(labels, jnp.int32), jnp.asarray(boxes), jnp.asarray(valid))
    jvars = jax.jit(lambda *a: jgen.init(jax.random.key(0), *a, 12, jax.random.key(1)))(*args)
    tgen = GenerateDNQueries(NUM_CLASSES, 16, groups, max_gt_cap_dn)
    assert tgen.label_encoder.weight.shape == (NUM_CLASSES, 15)
    with torch.no_grad():
        tgen.label_encoder.weight.copy_(_t(jvars["params"]["label_encoder"]["embedding"]))
    draws = _dn_draws(rng, len(gt_counts), jgen.dn_cap)
    jlabel, jbox, jbias, jmeta = jax.jit(lambda v, d, *a: jgen.apply(
        v, *a, 12, jax.random.key(1), noise_draws=d))(
        jvars, {k: jnp.asarray(v) for k, v in draws.items()}, *args)
    with torch.no_grad():
        tlabel, tbox, tbias, tmeta = tgen(_t(labels), _t(boxes), _t(valid), 12,
                                          noise_draws={k: _t(v) for k, v in draws.items()})
    assert set(tgen.draw_noise(1, None, "cpu")) == set(draws)
    np.testing.assert_allclose(tlabel.numpy(), np.asarray(jlabel), rtol=0, atol=1e-5)
    np.testing.assert_allclose(tbox.numpy(), np.asarray(jbox), rtol=0, atol=1e-5)
    np.testing.assert_array_equal(tbias.numpy(), np.asarray(jbias))
    for field in jmeta._fields:
        np.testing.assert_array_equal(getattr(tmeta, field).numpy(),
                                      np.asarray(getattr(jmeta, field)), err_msg=field)
    if gt_counts == (25,):
        assert int(tmeta.groups) == 2 < groups  # the group cut ran


@pytest.mark.parametrize("binary,mixed", [(True, 1), (False, 2), (True, 2)],
                         ids=["binary_cls", "mixed_match", "both"])
def test_binary_cls_and_mixed_match_match_jax(binary, mixed):
    """``two_stage_binary_cls`` (the encoder set against all-zero labels)
    and ``mixed_match`` (targets tiled, each GT matched to up to k
    queries) through ``relation_detr_loss`` on fixed random outputs,
    against the JAX criterion: every term at rtol 1e-5; ``tile_targets`` and
    ``calculate_loss`` under ``compute_matching``'s match on the tiled
    targets (the JAX one matches on its own) too."""
    rng = np.random.RandomState(51 + 2 * binary + mixed)
    labels, boxes, valid = _targets(rng, (3, 1), 5, 4, scatter=True)
    bs, nq, layers_ = 2, 12, 3

    def head(lead=()):
        logits = (rng.randn(*lead, bs, nq, 4) * 2).astype(np.float32)
        b = np.concatenate([rng.uniform(0.2, 0.8, (*lead, bs, nq, 2)),
                            rng.uniform(0.05, 0.5, (*lead, bs, nq, 2))], -1)
        return logits, b.astype(np.float32)

    main, enc = head((layers_,)), head()

    def outputs(conv):
        return {"pred_logits": conv(main[0][-1]), "pred_boxes": conv(main[1][-1]),
                "aux_outputs": {"pred_logits": conv(main[0][:-1]),
                                "pred_boxes": conv(main[1][:-1])},
                "enc_outputs": {"pred_logits": conv(enc[0]), "pred_boxes": conv(enc[1])}}

    kwargs = dict(num_classes=4, class_loss_type="focal", two_stage_binary_cls=binary,
                  mixed_match=mixed)
    cfg_t, cfg_j = tcrit.CriterionConfig(**kwargs), jcrit.CriterionConfig(**kwargs)
    jl, jb, jv = jnp.asarray(labels, jnp.int32), jnp.asarray(boxes), jnp.asarray(valid)
    want_total, want = jax.jit(lambda *a: jcrit.relation_detr_loss(cfg_j, *a))(
        outputs(jnp.asarray), jl, jb, jv)
    got_total, got = tcrit.relation_detr_loss(cfg_t, outputs(_t), _t(labels), _t(boxes),
                                              _t(valid))
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_allclose(got[k].item(), float(want[k]), rtol=1e-5, atol=1e-7,
                                   err_msg=k)
    np.testing.assert_allclose(got_total.item(), float(want_total), rtol=1e-5)
    for t, j in zip(tcrit.tile_targets(_t(labels), _t(boxes), _t(valid), mixed, 5),
                    jcrit.tile_targets(jl, jb, jv, mixed, 5)):
        np.testing.assert_array_equal(t.numpy(), np.asarray(j))
    num_boxes = float(valid.sum())
    want_one = jax.jit(lambda *a: jcrit.calculate_loss(cfg_j, *a))(
        jnp.asarray(enc[0]), jnp.asarray(enc[1]), jl, jb, jv, jnp.float32(num_boxes))
    tiled = tcrit.tile_targets(_t(labels), _t(boxes), _t(valid), mixed, nq)
    match = tcrit.compute_matching(cfg_t, _t(enc[0]), _t(enc[1]), *tiled)
    got_one = tcrit.calculate_loss(cfg_t, _t(enc[0]), _t(enc[1]), *tiled,
                                   torch.tensor(num_boxes), match)
    for k in want_one:
        np.testing.assert_allclose(got_one[k].item(), float(want_one[k]), rtol=1e-5,
                                   atol=1e-7, err_msg=k)


def test_decoder_without_relation_matches_jax():
    """``decoder_use_relation=False``: no relation parameters, every layer
    takes the denoising mask alone; the decoder's heads against the JAX
    decoder's (``use_relation=False``) with the same weights, at 2e-3."""
    rng = np.random.RandomState(61)
    shapes, bs, nq, c = ((6, 8), (3, 4)), 2, 14, 32
    s = sum(h * w for h, w in shapes)
    query = rng.randn(bs, nq, c).astype(np.float32)
    ref = rng.uniform(0.2, 0.8, (bs, nq, 4)).astype(np.float32)
    value = rng.randn(bs, s, c).astype(np.float32)
    ratios = np.ones((bs, 2, 2), np.float32)
    pad = np.zeros((bs, s), bool)
    bias = np.where(rng.rand(nq, nq) < 0.3, -1e9, 0.0).astype(np.float32)
    np.fill_diagonal(bias, 0.0)
    bias = bias[None, None]
    jdec = JDecoder(num_classes=5, embed_dim=c, d_ffn=48, num_heads=4, num_levels=2,
                    num_layers=2, use_relation=False)
    args = [jnp.asarray(a) for a in (query, ref, value)]
    rest = (jnp.asarray(ratios), jnp.asarray(pad), jnp.asarray(bias))
    jvars = jax.jit(lambda *a: jdec.init(jax.random.key(0), *a[:3], shapes, *a[3:]))(
        *args, *rest)
    assert "position_relation_embedding" not in jvars["params"]
    want = jax.jit(lambda v, *a: jdec.apply(v, *a[:3], shapes, *a[3:]))(jvars, *args, *rest)
    tdec = RelationTransformerDecoder(5, c, 48, 4, 2, 4, 2, use_relation=False)
    assert tdec.position_relation_embedding is None
    sd = state_dict_from_jax(flatten(jvars["params"]), {})
    tdec.load_state_dict(sd)
    with torch.no_grad():
        got = tdec(_t(query), _t(ref), _t(value), shapes, _t(ratios), _t(pad), _t(bias))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=TOL_HEADS, atol=TOL_HEADS)


def _tiny_dropout_model(p):
    """The port's tiny-test config (it has the hybrid branch, under which the
    transformer trains with dropout, as in JAX) at dropout ``p``."""
    tiny = importlib.import_module(
        "relation_detr_tpu_torch.configs.relation_detr.relation_detr_resnet50_tiny_test")
    return tiny, RelationDETR(**tiny.model_args, dropout=p,
                              generator=torch.Generator().manual_seed(3))


def _dropout_batch():
    rng = np.random.RandomState(71)
    labels, boxes, valid = _targets(rng, (2, 1), 3, 4)
    return [_t(rng.randn(2, 64, 96, 3).astype(np.float32)), torch.zeros(2, 64, 96, dtype=bool),
            _t(labels), _t(boxes), _t(valid)]


def test_dropout_is_the_identity_at_zero_and_in_eval():
    """``layers.dropout``: no generator at p = 0 or without a seed (and no
    draw from any generator); at p = 0.1 about a tenth of the elements
    zeroed and the rest scaled by 1 / 0.9, the same mask from the same seed.
    The tiny model at p = 0.1 gives the eval heads of p = 0 bit for bit,
    and at p = 0 its train forward does not depend on the dropout seed nor
    draw from torch's global generator."""
    assert layers.dropout_generator(5, 0.0, "cpu") is None
    assert layers.dropout_generator(None, 0.1, "cpu") is None
    x = torch.randn(200, 500)
    assert layers.dropout(x, 0.1, None) is x
    y = layers.dropout(x, 0.1, layers.dropout_generator(5, 0.1, "cpu"))
    zeroed = (y == 0).float().mean().item()
    assert 0.09 < zeroed < 0.11
    kept = y != 0
    torch.testing.assert_close(y[kept], x[kept] / 0.9)
    assert torch.equal(y, layers.dropout(x, 0.1, layers.dropout_generator(5, 0.1, "cpu")))

    batch = _dropout_batch()
    _, dropped = _tiny_dropout_model(0.1)
    tiny, plain = _tiny_dropout_model(0.0)
    with torch.no_grad():
        a, b = dropped.eval()(*batch[:2]), plain.eval()(*batch[:2])
        for k in ("pred_logits", "pred_boxes"):
            assert torch.equal(a[k], b[k]), k
        draws = plain.denoising_generator.draw_noise(2, torch.Generator().manual_seed(1), "cpu")
        state = torch.get_rng_state()
        first = plain.train()(*batch, train=True, noise_draws=draws, dropout_seed=1)
        second = plain(*batch, train=True, noise_draws=draws)
        assert torch.equal(torch.get_rng_state(), state)
        assert torch.equal(first["pred_logits"], second["pred_logits"])


@pytest.fixture
def deterministic():
    torch.use_deterministic_algorithms(True)
    yield
    torch.use_deterministic_algorithms(False)


def test_dropout_under_remat_is_bit_identical(deterministic):
    """At p = 0.1 the train forward depends on the seed (dropout is on),
    and remat "none" (each layer run again in the backward) gives the
    gradients of no remat bit for bit: the recompute draws the same
    masks."""
    tiny, _ = _tiny_dropout_model(0.1)
    batch = _dropout_batch()

    def run(policy, seed):
        model = RelationDETR(**tiny.model_args, dropout=0.1, remat_policy=policy,
                             generator=torch.Generator().manual_seed(3)).train()
        draws = model.denoising_generator.draw_noise(2, torch.Generator().manual_seed(1), "cpu")
        out = model(*batch, train=True, noise_draws=draws, dropout_seed=seed)
        total, _ = tcrit.relation_detr_loss(tiny.build_criterion(), out, *batch[2:])
        total.backward()
        return total.detach(), {n: p.grad for n, p in model.named_parameters()
                                if p.grad is not None}

    total, grads = run(None, 7)
    other, _ = run(None, 8)
    assert not torch.equal(total, other)
    again, regrads = run("none", 7)
    assert torch.equal(total, again)
    assert sorted(grads) == sorted(regrads)
    for n, g in grads.items():
        assert torch.equal(g, regrads[n]), n


def _fields(obj, cls):
    return {f.name: getattr(obj, f.name) for f in dataclasses.fields(cls)
            if f.name not in ("parent", "name")}


@pytest.mark.parametrize("config", list(CONFIGS))
def test_family_config_matches_jax(config):
    """Each port config's model and criterion equal the JAX config's: every
    ``RelationDETR`` field the port takes (its defaults where the config is
    silent), the JAX-only fields at their defaults, the ``CriterionConfig``
    fields, and the eval bounds."""
    port = Config("relation_detr_tpu_torch/configs/" + CONFIGS[config])
    ref = JConfig("configs/" + CONFIGS[config])
    jfields = _fields(ref.model, JRelationDETR)
    signature = inspect.signature(RelationDETR.__init__).parameters
    effective = {k: v.default for k, v in signature.items()
                 if v.default is not inspect.Parameter.empty}
    effective.update(port.model_args)
    for key, want in jfields.items():
        if key in signature:
            assert effective[key] == want, key
        else:
            assert want == JRelationDETR.__dataclass_fields__[key].default, key
    assert dataclasses.asdict(port.build_criterion()) == dataclasses.asdict(ref.criterion)
    for key in ("min_size", "max_size", "select_box_nums_for_evaluation", "hybrid_assign"):
        assert port.get(key) == ref.get(key), key
