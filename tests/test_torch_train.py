"""The port's train step against the JAX package, on the same numpy inputs.

Module by module (CDN generator, matcher, focal losses, the criterion) and
then the slice as a whole: the tiny-test config's train forward, loss and
backward on both sides with the same weights, batch and CDN draws, and one
optimizer step against optax. The JAX side runs jitted, its Pallas kernels
in interpret mode; the port's kernel wrappers take their plain versions on
CPU tensors. The JAX model gets the injected CDN draws through
``flax.linen.intercept_methods`` (its detector has no draws argument).
"""
import importlib
import math
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax import linen as nn

sys.path.insert(0, ".")
from tools.convert_torch_weights import convert_state_dict  # noqa: E402

from relation_detr_tpu.losses import criterion as jcrit  # noqa: E402
from relation_detr_tpu.losses import losses as jlosses  # noqa: E402
from relation_detr_tpu.models.denoising import (  # noqa: E402
    GenerateDenoisingQueries as JGenerator,
)
from relation_detr_tpu.models.detector import RelationDETR as JRelationDETR  # noqa: E402
from relation_detr_tpu.utils import param_groups as jpg  # noqa: E402
from relation_detr_tpu_torch.losses import criterion as tcrit  # noqa: E402
from relation_detr_tpu_torch.losses import losses as tlosses  # noqa: E402
from relation_detr_tpu_torch.models.denoising import GenerateCDNQueries  # noqa: E402
from relation_detr_tpu_torch.models.detector import RelationDETR  # noqa: E402
from relation_detr_tpu_torch.models.transformer import RelationTransformer  # noqa: E402
from relation_detr_tpu_torch.parallel.train_step import (  # noqa: E402
    apply_update,
    global_norm,
    make_train_step,
)
from relation_detr_tpu_torch.utils import param_groups as tpg  # noqa: E402
from relation_detr_tpu_torch.utils.weights import state_dict_from_jax  # noqa: E402
from tests.test_torch_modules import flatten, perturb, unflatten  # noqa: E402

TINY = importlib.import_module(
    "relation_detr_tpu_torch.configs.relation_detr.relation_detr_resnet50_tiny_test")


def _t(x):
    return torch.from_numpy(np.array(x))


def _targets(rng, gt_counts, cap, num_classes, scatter=False):
    """Padded targets; ``scatter`` puts padding slots between valid ones."""
    bs = len(gt_counts)
    labels = np.full((bs, cap), -1, np.int64)
    boxes = np.zeros((bs, cap, 4), np.float32)
    valid = np.zeros((bs, cap), bool)
    for b, n in enumerate(gt_counts):
        slots = np.sort(rng.choice(cap, n, replace=False)) if scatter else np.arange(n)
        labels[b, slots] = rng.randint(0, num_classes, n)
        centres = rng.uniform(0.25, 0.75, (n, 2))
        sizes = rng.uniform(0.1, 0.4, (n, 2))
        boxes[b, slots] = np.concatenate([centres, sizes], 1)
        valid[b, slots] = True
    return labels, boxes, valid


def _cdn_draws(rng, bs, dn_cap, num_classes):
    return {
        "flip_u": rng.rand(bs, dn_cap).astype(np.float32),
        "random_labels": rng.randint(0, num_classes, (bs, dn_cap)),
        "rand_sign": rng.choice([-1.0, 1.0], (bs, dn_cap, 4)).astype(np.float32),
        "rand_part": rng.rand(bs, dn_cap, 4).astype(np.float32),
    }


def _generators(num_classes, embed_dim, denoising_nums, labels, boxes, valid, num_queries):
    """The JAX CDN generator (initialised) and the port's, same embedding."""
    jgen = JGenerator(num_classes=num_classes, embed_dim=embed_dim, contrastive=True,
                      denoising_nums=denoising_nums, label_noise_prob=0.5,
                      box_noise_scale=1.0)
    jvars = jgen.init(jax.random.key(0), jnp.asarray(labels, jnp.int32), jnp.asarray(boxes),
                      jnp.asarray(valid), num_queries, jax.random.key(1))
    tgen = GenerateCDNQueries(num_classes, embed_dim, denoising_nums)
    with torch.no_grad():
        tgen.label_encoder.weight.copy_(
            _t(jvars["params"]["label_encoder"]["embedding"]))
    return jgen, jvars, tgen


def _run_generators(gt_counts, cap, seed, num_classes=11, embed_dim=16, denoising_nums=6,
                    num_queries=10):
    rng = np.random.RandomState(seed)
    labels, boxes, valid = _targets(rng, gt_counts, cap, num_classes)
    jgen, jvars, tgen = _generators(num_classes, embed_dim, denoising_nums, labels, boxes,
                                    valid, num_queries)
    draws = _cdn_draws(rng, len(gt_counts), jgen.dn_cap, num_classes)
    jout = jgen.apply(jvars, jnp.asarray(labels, jnp.int32), jnp.asarray(boxes),
                      jnp.asarray(valid), num_queries, jax.random.key(1),
                      noise_draws={k: jnp.asarray(v) for k, v in draws.items()})
    with torch.no_grad():
        tout = tgen(_t(labels), _t(boxes), _t(valid), num_queries,
                    noise_draws={k: _t(v) for k, v in draws.items()})
    return jout, tout


@pytest.mark.parametrize("gt_counts,cap", [((3, 1), 5), ((2, 5, 4), 7), ((0, 0), 3),
                                           ((100,), 100)])
def test_cdn_generator_matches_jax(gt_counts, cap):
    """Label queries, box queries (logit space), the attention bias and
    every DenoisingMeta field with the same injected draws: queries atol
    1e-5, the rest exact. (100,) is the loader's GT capacity filled, where
    one group remains."""
    (jlabel, jbox, jbias, jmeta), (tlabel, tbox, tbias, tmeta) = _run_generators(
        gt_counts, cap, seed=sum(gt_counts) + cap)
    np.testing.assert_allclose(tlabel.numpy(), np.asarray(jlabel), rtol=0, atol=1e-5)
    np.testing.assert_allclose(tbox.numpy(), np.asarray(jbox), rtol=0, atol=1e-5)
    assert tbias.shape == jbias.shape
    np.testing.assert_array_equal(tbias.numpy(), np.asarray(jbias))
    for field in jmeta._fields:
        np.testing.assert_array_equal(getattr(tmeta, field).numpy(),
                                      np.asarray(getattr(jmeta, field)), err_msg=field)


def _matching_inputs(seed, bs=2, num_queries=40, num_classes=5, gt_counts=(4, 2), cap=6,
                     sets=3):
    rng = np.random.RandomState(seed)
    labels, boxes, valid = _targets(rng, gt_counts, cap, num_classes, scatter=True)
    logits = rng.randn(sets, bs, num_queries, num_classes).astype(np.float32)
    centres = rng.uniform(0.1, 0.9, (sets, bs, num_queries, 2))
    sizes = rng.uniform(0.05, 0.5, (sets, bs, num_queries, 2))
    pred_boxes = np.concatenate([centres, sizes], -1).astype(np.float32)
    return logits, pred_boxes, labels, boxes, valid


def _match_cost(cost, match, valid):
    """Sum of the cost over each image's matched valid GT."""
    b_ix, g_ix = np.nonzero(valid)
    return np.array([cost[b, match[b, g], g] for b, g in zip(b_ix, g_ix)]).sum()


@pytest.mark.parametrize("tiled", [False, True], ids=["padded", "hybrid_tiled"])
def test_matching_matches_jax_by_optimal_cost(tiled):
    """``compute_matching`` (scipy on the valid rows) vs the JAX on-device
    solver (padded rows at zero cost), per output set: the same optimal
    cost (rtol 1e-5), a one-to-one assignment, -1 on padding. ``tiled``
    repeats the targets 6x as the hybrid branch does, where copies of a
    GT tie and only the cost is unique."""
    logits, pred_boxes, labels, boxes, valid = _matching_inputs(3 + tiled)
    if tiled:
        labels, boxes, valid = (np.tile(labels, (1, 6)), np.tile(boxes, (1, 6, 1)),
                                np.tile(valid, (1, 6)))
    cfg_t, cfg_j = tcrit.CriterionConfig(num_classes=5), jcrit.CriterionConfig(num_classes=5)
    got = tcrit.compute_matching(cfg_t, _t(logits), _t(pred_boxes), _t(labels), _t(boxes),
                                 _t(valid)).numpy()
    for s in range(logits.shape[0]):
        want = np.asarray(jcrit.compute_matching(
            cfg_j, jnp.asarray(logits[s]), jnp.asarray(pred_boxes[s]),
            jnp.asarray(labels, jnp.int32), jnp.asarray(boxes), jnp.asarray(valid)))
        assert (got[s][~valid] == -1).all()
        for b in range(valid.shape[0]):
            cols = got[s, b][valid[b]]
            assert len(set(cols.tolist())) == len(cols)
        cost = tcrit.matching_cost(cfg_t, _t(logits[s]), _t(pred_boxes[s]), _t(labels),
                                   _t(boxes)).numpy()
        np.testing.assert_allclose(_match_cost(cost, got[s], valid),
                                   _match_cost(cost, want, valid), rtol=1e-5)


@pytest.mark.parametrize("masked", [False, True])
def test_focal_losses_match_jax(masked):
    """sigmoid_focal_loss and vari_sigmoid_focal_loss, value and logit
    gradient, with and without a query mask: rtol 1e-5."""
    rng = np.random.RandomState(12)
    logits = (rng.randn(2, 30, 6) * 3).astype(np.float32)
    onehot = np.eye(7, dtype=np.float32)[rng.randint(0, 7, (2, 30))][..., :6]
    score = rng.rand(2, 30).astype(np.float32)
    qmask = (rng.rand(2, 30) > 0.3).astype(np.float32) if masked else None
    jmask = None if qmask is None else jnp.asarray(qmask)
    tmask = None if qmask is None else _t(qmask)
    cases = {
        "focal": (lambda lg: jlosses.sigmoid_focal_loss(lg, jnp.asarray(onehot), 7.0,
                                                        query_mask=jmask),
                  lambda lg: tlosses.sigmoid_focal_loss(lg, _t(onehot), 7.0,
                                                        query_mask=tmask)),
        "vari_focal": (lambda lg: jlosses.vari_sigmoid_focal_loss(
                           lg, jnp.asarray(onehot), jnp.asarray(score), 7.0, query_mask=jmask),
                       lambda lg: tlosses.vari_sigmoid_focal_loss(
                           lg, _t(onehot), _t(score), 7.0, query_mask=tmask)),
    }
    for name, (jfn, tfn) in cases.items():
        want, want_grad = jax.value_and_grad(jfn)(jnp.asarray(logits))
        lg = _t(logits).requires_grad_(True)
        got = tfn(lg)
        got.backward()
        np.testing.assert_allclose(got.item(), float(want), rtol=1e-5, err_msg=name)
        np.testing.assert_allclose(lg.grad.numpy(), np.asarray(want_grad), rtol=1e-5,
                                   atol=1e-5 * np.abs(want_grad).max(), err_msg=name)


def _fixed_outputs(seed, num_layers=3, bs=2, nq=12, nh=18, num_classes=4, dn_cap=10):
    rng = np.random.RandomState(seed)

    def head(n, lead=()):
        logits = (rng.randn(*lead, bs, n, num_classes) * 2).astype(np.float32)
        boxes = np.concatenate([rng.uniform(0.2, 0.8, (*lead, bs, n, 2)),
                                rng.uniform(0.05, 0.5, (*lead, bs, n, 2))], -1)
        return logits, boxes.astype(np.float32)

    return {
        "main": head(nq, (num_layers,)), "enc": head(nq), "dn": head(dn_cap, (num_layers,)),
        "hybrid": head(nh, (num_layers,)), "hybrid_enc": head(nh),
    }


def _outputs_dict(raw, meta, conv):
    def pair(x):
        return {"pred_logits": conv(x[0]), "pred_boxes": conv(x[1])}

    main, hyb = pair(raw["main"]), pair(raw["hybrid"])
    return {
        "pred_logits": main["pred_logits"][-1], "pred_boxes": main["pred_boxes"][-1],
        "aux_outputs": {k: v[:-1] for k, v in main.items()},
        "enc_outputs": pair(raw["enc"]),
        "dn_outputs": pair(raw["dn"]), "dn_meta": meta,
        "hybrid_outputs": {
            "pred_logits": hyb["pred_logits"][-1], "pred_boxes": hyb["pred_boxes"][-1],
            "aux_outputs": {k: v[:-1] for k, v in hyb.items()},
            "enc_outputs": pair(raw["hybrid_enc"]),
        },
    }


def test_relation_detr_loss_matches_jax_on_fixed_outputs():
    """The weighted total and every loss term (matching, varifocal, L1,
    GIoU, CDN with its group scaling, the 6x tiled hybrid set) on fixed
    random outputs and padded targets: rtol 1e-5. The assignments agree
    first (continuous random costs leave one optimum; the hybrid set's GT
    copies tie, which permutes copies and changes no loss)."""
    rng = np.random.RandomState(21)
    labels, boxes, valid = _targets(rng, (3, 1), 5, 4, scatter=True)
    raw = _fixed_outputs(22)
    jgen, jvars, tgen = _generators(4, 16, 5, labels, boxes, valid, 12)
    draws = _cdn_draws(rng, 2, jgen.dn_cap, 4)
    jmeta = jgen.apply(jvars, jnp.asarray(labels, jnp.int32), jnp.asarray(boxes),
                       jnp.asarray(valid), 12, jax.random.key(1),
                       noise_draws={k: jnp.asarray(v) for k, v in draws.items()})[3]
    tmeta = tgen(_t(labels), _t(boxes), _t(valid), 12,
                 noise_draws={k: _t(v) for k, v in draws.items()})[3]
    cfg_t, cfg_j = tcrit.CriterionConfig(num_classes=4), jcrit.CriterionConfig(num_classes=4)

    jout = _outputs_dict(raw, jmeta, jnp.asarray)
    tout = _outputs_dict(raw, tmeta, _t)
    jl, jb, jv = jnp.asarray(labels, jnp.int32), jnp.asarray(boxes), jnp.asarray(valid)
    want_total, want = jcrit.relation_detr_loss(cfg_j, jout, jl, jb, jv, 6)
    got_total, got = tcrit.relation_detr_loss(cfg_t, tout, _t(labels), _t(boxes), _t(valid), 6)
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_allclose(got[k].item(), float(want[k]), rtol=1e-5, atol=1e-7,
                                   err_msg=k)
    np.testing.assert_allclose(got_total.item(), float(want_total), rtol=1e-5)
    weights_t = tcrit.build_weight_dict(cfg_t, 3, True, True)
    assert weights_t == jcrit.build_weight_dict(cfg_j, 3, True, True)


# ---------------------------------------------------------------------------
# the slice as a whole: the tiny-test config's train step
# ---------------------------------------------------------------------------

B, H, W = 2, 128, 160
GT_COUNTS, GT_CAP = (4, 2), 6
TOL_LOSS = 1e-4  # relative, every loss term
TOL_GRAD = 1e-3  # of each leaf's max |grad|
TOL_STEP = 1e-6  # absolute, parameters after one AdamW step


def _jax_train_loss(jmodel, cfg, hybrid_assign):
    """jit(value_and_grad) of the JAX train loss with injected CDN draws;
    the aux output holds the loss dict, the two top-k index sets and the
    raw outputs for matching."""

    def loss_fn(params, stats, images, mask, labels, boxes, valid, draws):
        def inject(next_fun, args, kwargs, context):
            if isinstance(context.module, JGenerator) and context.method_name == "__call__":
                kwargs = {**kwargs, "noise_draws": draws}
            return next_fun(*args, **kwargs)

        with nn.intercept_methods(inject):
            outputs, inter = jmodel.apply(
                {"params": params, "batch_stats": stats}, images, mask, labels, boxes, valid,
                train=True, rngs={"denoising": jax.random.key(0)},
                capture_intermediates=lambda mdl, name: name == "_select_topk",
                mutable=["intermediates"])
        total, losses = jcrit.relation_detr_loss(cfg, outputs, labels, boxes, valid,
                                                 hybrid_assign)
        topk = [out[2] for out in inter["intermediates"]["transformer"]["_select_topk"]]
        heads = {"main": (outputs["pred_logits"], outputs["pred_boxes"]),
                 "hybrid": (outputs["hybrid_outputs"]["pred_logits"],
                            outputs["hybrid_outputs"]["pred_boxes"])}
        return total, (losses, topk, heads)

    return jax.jit(jax.value_and_grad(loss_fn, has_aux=True))


@pytest.fixture(scope="module")
def slice_pair():
    """One train forward + backward of the tiny-test config on each side,
    same (perturbed) weights, batch and CDN draws."""
    model = RelationDETR(**TINY.model_args, generator=torch.Generator().manual_seed(0))
    rng = np.random.RandomState(31)
    sd = {k: v.numpy() for k, v in model.state_dict().items()}
    noisy = perturb({k: v for k, v in sd.items()
                     if not k.startswith("backbone.") or "bn" in k or "downsample.1" in k},
                    rng, 0.02)
    model.load_state_dict({k: torch.from_numpy(v) for k, v in {**sd, **noisy}.items()})
    params, stats, leftover = convert_state_dict(dict(model.state_dict()))
    assert not leftover, leftover[:8]

    images = rng.randn(B, H, W, 3).astype(np.float32)
    mask = np.zeros((B, H, W), bool)
    mask[1, 96:] = True
    mask[1, :, 112:] = True
    images[mask] = 0.0
    labels, boxes, valid = _targets(rng, GT_COUNTS, GT_CAP, TINY.num_classes, scatter=True)
    dn_cap = model.denoising_generator.dn_cap
    draws = _cdn_draws(rng, B, dn_cap, TINY.num_classes)

    jmodel = JRelationDETR(**TINY.model_args)
    jcfg = jcrit.CriterionConfig(**TINY.criterion_args)
    (jtotal, (jlosses_, jtopk, jheads)), jgrads = _jax_train_loss(
        jmodel, jcfg, TINY.hybrid_assign)(
        unflatten(params), unflatten(stats), jnp.asarray(images), jnp.asarray(mask),
        jnp.asarray(labels, jnp.int32), jnp.asarray(boxes), jnp.asarray(valid),
        {k: jnp.asarray(v) for k, v in draws.items()})

    ttopk = []
    select = RelationTransformer._select_topk

    def recording_select(*args):
        out = select(*args)
        ttopk.append(out[2].numpy().copy())
        return out

    RelationTransformer._select_topk = staticmethod(recording_select)
    try:
        model.train()
        outputs = model(_t(images), _t(mask), _t(labels), _t(boxes), _t(valid), train=True,
                        noise_draws={k: _t(v) for k, v in draws.items()})
    finally:
        RelationTransformer._select_topk = staticmethod(select)
    ttotal, tlosses_ = tcrit.relation_detr_loss(TINY.build_criterion(), outputs, _t(labels),
                                                _t(boxes), _t(valid), TINY.hybrid_assign)
    ttotal.backward()
    pair = dict(model=model, params=params, stats=stats, labels=labels, boxes=boxes,
                valid=valid, jtotal=jtotal, jlosses=jlosses_, jtopk=jtopk, jheads=jheads,
                jgrads=flatten(jgrads), ttopk=ttopk, outputs=outputs, ttotal=ttotal,
                tlosses=tlosses_)
    pair["selection"] = _selection_and_matching(pair)
    return pair


def _selection_and_matching(p):
    """Per check, None if the port agrees with JAX, else what differs: the
    encoder and hybrid top-k indices, then each set's assignment (exact for
    the main set, equal column sets per GT for the 6x tiled hybrid set)."""
    found = {}
    for name, got, want in zip(("encoder top-k", "hybrid top-k"), p["ttopk"], p["jtopk"]):
        found[name] = None if np.array_equal(got, np.asarray(want)) else (
            f"{name} indices differ from JAX: a top-k tie flipped, choose another seed")
    cfg_t, cfg_j = TINY.build_criterion(), jcrit.CriterionConfig(**TINY.criterion_args)
    labels, boxes, valid = p["labels"], p["boxes"], p["valid"]
    heads = {"main": p["outputs"], "hybrid": p["outputs"]["hybrid_outputs"]}
    for name, reps in (("main", 1), ("hybrid", TINY.hybrid_assign)):
        jl, jb = p["jheads"][name]
        lab, box, val = (np.tile(labels, (1, reps)), np.tile(boxes, (1, reps, 1)),
                         np.tile(valid, (1, reps)))
        want = np.asarray(jcrit.compute_matching(
            cfg_j, jl, jb, jnp.asarray(lab, jnp.int32), jnp.asarray(box), jnp.asarray(val)))
        got = tcrit.compute_matching(cfg_t, heads[name]["pred_logits"].detach(),
                                     heads[name]["pred_boxes"].detach(), _t(lab), _t(box),
                                     _t(val)).numpy()

        def per_gt(m, b):
            return sorted(tuple(sorted(m[b, g::GT_CAP][val[b, g::GT_CAP]].tolist()))
                          for g in range(GT_CAP))

        bad = [b for b in range(B) if per_gt(got, b) != per_gt(want, b)]
        found[f"{name} matching"] = f"{name} set: assignments differ, images {bad}" if bad \
            else None
    return found


def _assert_same_selection_and_matching(p):
    for problem in p["selection"].values():
        assert problem is None, problem


def test_train_topk_and_matching_match_jax(slice_pair):
    """The encoder top-k and the hybrid top-k pick the same proposals as
    JAX (a tie flipped by another contraction order would change every
    loss after it), and every output set gets an equal assignment."""
    assert set(slice_pair["selection"]) == {"encoder top-k", "hybrid top-k",
                                            "main matching", "hybrid matching"}
    _assert_same_selection_and_matching(slice_pair)


def test_train_losses_match_jax(slice_pair):
    """Every loss term and the weighted total of the train forward: rtol
    1e-4, once the top-k and the assignments are known to agree."""
    p = slice_pair
    _assert_same_selection_and_matching(p)
    assert sorted(p["tlosses"]) == sorted(p["jlosses"])
    for k, want in p["jlosses"].items():
        got = p["tlosses"][k].item()
        assert math.isfinite(got), k
        np.testing.assert_allclose(got, float(want), rtol=TOL_LOSS, atol=1e-7, err_msg=k)
    np.testing.assert_allclose(p["ttotal"].item(), float(p["jtotal"]), rtol=TOL_LOSS)


def test_train_grads_match_jax(slice_pair):
    """Every trainable parameter's gradient against jax.grad, within 1e-3
    of the leaf's max |grad|; the frozen stem and layer1 get none."""
    p = slice_pair
    _assert_same_selection_and_matching(p)
    want = state_dict_from_jax(p["jgrads"], {})
    checked = 0
    for name, param in p["model"].named_parameters():
        if not param.requires_grad:
            assert param.grad is None, name
            assert name.startswith(("backbone.conv1", "backbone.layer1.")), name
            continue
        w = want[name].numpy()
        assert param.grad is not None, name
        scale = float(np.abs(w).max())
        np.testing.assert_allclose(param.grad.numpy(), w, rtol=0,
                                   atol=TOL_GRAD * scale + 1e-12, err_msg=name)
        checked += 1
    assert checked > 100


def test_optimizer_step_matches_optax(slice_pair):
    """One clipped AdamW step from the same gradients (JAX's, carried to the
    port's layout): the port's ``build_optimizer`` + ``apply_update`` vs the
    JAX ``build_optimizer`` optax chain, warm-up lr from
    ``warmup_multistep_schedule``: atol 1e-6 on every parameter the port
    trains. Both sides see zero gradients on every leaf the JAX chain
    freezes (its name test also freezes each later block's conv1, which the
    port trains), so the clip norms agree. The port's frozen stem and layer1
    stay bit-identical; the JAX chain decays them (ROADMAP Queue 3)."""
    p = slice_pair
    jgrads = dict(p["jgrads"])
    for key in jgrads:
        if jpg.is_frozen(tuple(key.split("/"))):
            jgrads[key] = np.zeros_like(jgrads[key])
    schedule_t = tpg.warmup_multistep_schedule(2e-4, 50, warmup_steps=20)
    schedule_j = jpg.warmup_multistep_schedule(2e-4, 50, warmup_steps=20)
    for step in (0, 7, 20, 499, 500, 501):
        np.testing.assert_allclose(schedule_t(step), float(schedule_j(step)), rtol=1e-6)
    tx = jpg.build_optimizer(schedule_j)
    jparams = unflatten(p["params"])
    updates, _ = tx.update(unflatten(jgrads), tx.init(jparams), jparams)
    want = state_dict_from_jax(flatten(optax.apply_updates(jparams, updates)), p["stats"])

    model = RelationDETR(**TINY.model_args, generator=torch.Generator().manual_seed(5))
    model.load_state_dict(p["model"].state_dict())
    grads = state_dict_from_jax(jgrads, {})
    trainable = [q for q in model.parameters() if q.requires_grad]
    for name, q in model.named_parameters():
        if q.requires_grad:
            q.grad = grads[name].clone()
    optimizer = tpg.build_optimizer(model, schedule_t)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    norm = global_norm(q.grad for q in trainable)
    np.testing.assert_allclose(norm.item(), float(optax.global_norm(unflatten(jgrads))),
                               rtol=1e-5)
    assert norm.item() > optimizer.max_norm  # the clip is on
    apply_update(optimizer, trainable, norm, norm.item(), 0)
    moved = 0
    for name, q in model.named_parameters():
        if q.requires_grad:
            np.testing.assert_allclose(q.detach().numpy(), want[name].numpy(), rtol=0,
                                       atol=TOL_STEP, err_msg=name)
            moved += int(not torch.equal(q.detach(), before[name]))
        else:
            assert torch.equal(q.detach(), before[name]), name
    assert moved > 100


def _small_batch(seed, nan=False):
    rng = np.random.RandomState(seed)
    labels, boxes, valid = _targets(rng, (2, 1), 3, TINY.num_classes)
    images = rng.randn(1 + 1, 64, 96, 3).astype(np.float32)
    if nan:
        images[0, 10, 10, 0] = np.nan
    mask = np.zeros((2, 64, 96), bool)
    mask[1, :, 64:] = True
    return {"images": _t(images), "mask": _t(mask), "gt_labels": _t(labels),
            "gt_boxes": _t(boxes), "gt_valid": _t(valid)}


def test_train_step_skips_nonfinite_update():
    """A step whose loss is NaN leaves every parameter and the whole
    optimizer state unchanged, and counts 1 with its step index; the
    metrics carry the JAX step's keys."""
    model = TINY.build_model(device="cpu", seed=3).train()
    optimizer = tpg.build_optimizer(model, 1e-4)
    step = make_train_step(model, TINY.build_criterion(), optimizer, TINY.hybrid_assign,
                           seed=4)
    first = step(_small_batch(0))
    assert first["nonfinite_count"] == 0 and first["first_nonfinite_step"] == -1
    assert math.isfinite(first["total_loss"]) and math.isfinite(first["grad_norm"])
    weights = tcrit.build_weight_dict(TINY.build_criterion(), 2, True, True)
    meta_keys = {"total_loss", "grad_norm", "nonfinite_count", "first_nonfinite_step"}
    assert meta_keys | {"loss_class", "loss_bbox_0", "loss_giou_dn", "loss_class_enc",
                        "loss_bbox_enc_hybrid"} <= set(first)
    assert set(first) - meta_keys <= set(weights)
    params = {k: v.clone() for k, v in model.state_dict().items()}
    opt_state = {id(q): {k: v.clone() for k, v in s.items()}
                 for q, s in optimizer.state.items()}
    bad = step(_small_batch(1, nan=True))
    assert not math.isfinite(bad["total_loss"])
    assert bad["nonfinite_count"] == 1 and bad["first_nonfinite_step"] == 1
    for k, v in model.state_dict().items():
        assert torch.equal(v, params[k]), k
    for q, s in optimizer.state.items():
        for k, v in s.items():
            assert torch.equal(v, opt_state[id(q)][k]), k
    assert step.state.updates == 1 and step.state.step == 2
    again = step(_small_batch(2))
    assert again["nonfinite_count"] == 1 and math.isfinite(again["total_loss"])
    assert step.state.updates == 2


def test_optimizer_groups_follow_the_jax_masks():
    """Each trainable parameter's (lr factor, weight decay) group agrees with
    the JAX masks on the same leaf; frozen leaves are in no group; the
    accumulation option names its ROADMAP item."""
    model = TINY.build_model(device="cpu")
    params, _, _ = convert_state_dict(dict(model.state_dict()))
    optimizer = tpg.build_optimizer(model, 1e-4)
    group_of = {id(q): g for g in optimizer.param_groups for q in g["params"]}
    by_name = dict(model.named_parameters())
    names = {}
    for key in params:
        if key.split("/")[-2] in ("q_proj", "k_proj", "v_proj"):
            continue  # merged into in_proj_* on the port's side
        for tname in state_dict_from_jax({key: params[key]}, {}):
            names[tname] = tuple(key.split("/"))
    for tname, jnames in names.items():
        q = by_name.get(tname)
        if q is None:
            continue
        if not q.requires_grad:
            assert id(q) not in group_of and jpg.is_frozen(jnames), tname
            continue
        g = group_of[id(q)]
        assert g["lr_factor"] == (0.1 if jpg.is_low_lr(jnames) else 1.0), tname
        assert (g["weight_decay"] == 0.0) == jpg.is_no_weight_decay(jnames), tname
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tpg.build_optimizer(model, 1e-4, accumulate_steps=2)
