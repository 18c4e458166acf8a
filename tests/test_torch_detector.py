"""The port's eval forward against the JAX RelationDETR with the same weights.

Weights are the port's seeded initialisation (perturbed), carried to the
JAX model by ``tools/convert_torch_weights.py::convert_state_dict`` and back
by ``state_dict_from_jax``; the JAX parameter tree comes from an abstract
``init`` (a concrete one takes minutes on CPU). Cases as in
tests/test_full_detector_parity.py.
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
from relation_detr_tpu.models.post_process import post_process as j_post_process  # noqa: E402
from relation_detr_tpu_torch.inference import detect  # noqa: E402
from relation_detr_tpu_torch.models.detector import RelationDETR  # noqa: E402
from relation_detr_tpu_torch.utils.weights import load_weights  # noqa: E402
from tests.test_torch_modules import flatten, perturb, unflatten  # noqa: E402

CASES = {
    "toy": dict(
        model=dict(num_classes=7, embed_dim=64, dim_feedforward=128, num_heads=4,
                   num_queries=20, hybrid_num_proposals=30, transformer_enc_layers=2,
                   transformer_dec_layers=2),
        b=2, h=128, w=160, topk=25,
    ),
    # the flagship config's widths and depths on a small canvas
    "flagship": dict(
        model=dict(num_classes=91, embed_dim=256, dim_feedforward=2048, num_heads=8,
                   num_queries=900, hybrid_num_proposals=1500, transformer_enc_layers=6,
                   transformer_dec_layers=6),
        b=1, h=256, w=320, topk=100,
    ),
}


def _jax_param_shapes(jmodel, b, h, w):
    """The JAX model's full parameter tree (train=True creates the hybrid and
    CDN parameters too), traced abstractly: shapes without values."""
    tree = jax.eval_shape(lambda: jmodel.init(
        {"params": jax.random.key(0), "denoising": jax.random.key(1)},
        jnp.zeros((b, h, w, 3)), jnp.zeros((b, h, w), bool),
        jnp.zeros((b, 4), jnp.int32), jnp.full((b, 4, 4), 0.5), jnp.zeros((b, 4), bool),
        train=True,
    ))
    return {
        name: {"/".join(str(getattr(k, "key", k)) for k in path): tuple(leaf.shape)
               for path, leaf in jax.tree_util.tree_flatten_with_path(tree[name])[0]}
        for name in ("params", "batch_stats")
    }


@pytest.fixture(scope="module", params=list(CASES))
def pair(request):
    """Seeded port weights, perturbed so zero-initialised heads and identity
    BN statistics take part, carried to the JAX model by convert_state_dict."""
    case = CASES[request.param]
    b, h, w = case["b"], case["h"], case["w"]
    model = RelationDETR(**case["model"], backbone_arch="resnet50",
                         generator=torch.Generator().manual_seed(0)).eval()
    rng = np.random.RandomState(7)
    sd = {k: v.numpy() for k, v in model.state_dict().items()}
    noisy = perturb({k: v for k, v in sd.items()
                     if not k.startswith("backbone.") or "bn" in k or "downsample.1" in k},
                    rng, 0.02)
    model.load_state_dict({k: torch.from_numpy(v) for k, v in {**sd, **noisy}.items()})
    params, stats, leftover = convert_state_dict(dict(model.state_dict()))
    assert not leftover, leftover[:8]

    jmodel = JRelationDETR(**case["model"], backbone_arch="resnet50")
    images = rng.randn(b, h, w, 3).astype(np.float32)
    mask = np.zeros((b, h, w), bool)
    mask[b - 1, (3 * h) // 4:, :] = True
    mask[b - 1, :, (3 * w) // 4:] = True
    images[mask] = 0.0
    # jit: one XLA compile is far quicker on CPU than eager op-by-op dispatch
    apply = jax.jit(lambda v, x, m: jmodel.apply(v, x, m, train=False))
    jout = apply({"params": unflatten(params), "batch_stats": unflatten(stats)},
                 jnp.asarray(images), jnp.asarray(mask))
    with torch.no_grad():
        tout = model(torch.from_numpy(images), torch.from_numpy(mask))
    return dict(case=case, params=params, stats=stats, model=model, images=images,
                mask=mask, jout=jout, tout=tout,
                jax_shapes=_jax_param_shapes(jmodel, b, h, w))


def test_eval_forward_matches_jax(pair):
    case, jout, tout = pair["case"], pair["jout"], pair["tout"]
    for name in ("pred_logits", "pred_boxes"):
        got, want = tout[name].numpy(), np.asarray(jout[name])
        assert got.shape == want.shape
        assert np.isfinite(got).all()
        if case["model"]["num_queries"] >= 900:
            # top-900 proposal ties flip between frameworks (fp noise), so a
            # few queries hold other proposals; a layout bug breaks them all
            bad = (np.abs(got - want) > 2e-3 + 2e-3 * np.abs(want)).any(-1)
            assert bad.mean() <= 0.03, f"{name}: {bad.sum()}/{bad.size} queries differ"
        else:
            np.testing.assert_allclose(got, want, rtol=2e-3, atol=2e-3, err_msg=name)


def test_detections_match_jax(pair):
    case, jout = pair["case"], pair["jout"]
    b, topk = case["b"], case["topk"]
    sizes = np.array([[96.0, 128.0], [64.0, 80.0]][:b], np.float32)
    det = detect(pair["model"], pair["images"], pair["mask"], sizes, topk)
    jdet = j_post_process(jout["pred_logits"], jout["pred_boxes"], jnp.asarray(sizes), topk)
    assert det["boxes"].shape == (b, topk, 4)
    np.testing.assert_allclose(det["scores"].numpy(), np.asarray(jdet["scores"]),
                               rtol=2e-3, atol=2e-3)
    # top-k ties may order differently: match (label, box) sets per image
    allowed = max(2, topk // 10) if topk < 100 else topk // 5
    for i in range(b):
        ours = sorted(zip(det["labels"][i].tolist(), np.round(det["boxes"][i].numpy(), 2).tolist()))
        ref = sorted(zip(np.asarray(jdet["labels"])[i].tolist(),
                         np.round(np.asarray(jdet["boxes"])[i], 2).tolist()))
        matched = sum(1 for a, r in zip(ours, ref)
                      if a[0] == r[0] and np.allclose(a[1], r[1], atol=0.6))
        assert matched >= topk - allowed, f"image {i}: {matched}/{topk} matched"


def test_weight_bridge_round_trip(pair, tmp_path):
    """The port's state_dict holds exactly the JAX model's parameters (names
    and shapes, hybrid and CDN included), and convert_state_dict followed by
    a JAX-format .npz weight file and ``load_weights(strict=True)`` gives
    every tensor back bit for bit."""
    for name, flat in (("params", pair["params"]), ("batch_stats", pair["stats"])):
        want = pair["jax_shapes"][name]
        got = {k: tuple(v.shape) for k, v in flat.items()}
        assert want == got, sorted(set(want) ^ set(got))[:8]
    path = str(tmp_path / "weights.npz")
    np.savez(path, **{f"params/{k}": v for k, v in pair["params"].items()},
             **{f"batch_stats/{k}": v for k, v in pair["stats"].items()})
    fresh = RelationDETR(**pair["case"]["model"], backbone_arch="resnet50",
                         generator=torch.Generator().manual_seed(1))
    report = load_weights(fresh, path, strict=True)
    assert not report["missing"] and not report["mismatched"]
    for k, v in pair["model"].state_dict().items():
        assert torch.equal(fresh.state_dict()[k], v), k
