"""Port modules against the JAX modules with the same weights, bridged by
``relation_detr_tpu_torch.utils.weights.state_dict_from_jax``."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from relation_detr_tpu.models.attention import (
    MultiScaleDeformableAttention as JMSDA,
)
from relation_detr_tpu.models.backbones.resnet import ResNetBackbone as JResNet
from relation_detr_tpu.models.neck import ChannelMapper as JChannelMapper
from relation_detr_tpu_torch.models.attention import MultiScaleDeformableAttention
from relation_detr_tpu_torch.models.backbones import build_backbone
from relation_detr_tpu_torch.models.neck import ChannelMapper
from relation_detr_tpu_torch.utils.weights import state_dict_from_jax


def flatten(tree, prefix=""):
    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        key = "/".join(str(getattr(k, "key", k)) for k in path)
        out[prefix + key] = np.asarray(leaf)
    return out


def unflatten(flat):
    tree = {}
    for key, value in flat.items():
        node = tree
        parts = key.split("/")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = jnp.asarray(value)
    return tree


def perturb(flat, rng, scale):
    """Random offsets on every array, so zero- or one-initialised weights
    and identity BN statistics cannot hide a layout bug."""
    out = {}
    for k, v in flat.items():
        noise = rng.randn(*v.shape).astype(np.float32) * scale
        out[k] = np.abs(v + noise) + 0.1 if k.endswith("running_var") else v + noise
    return out


def strip(sd, prefix):
    return {k[len(prefix):]: v for k, v in sd.items() if k.startswith(prefix)}


def test_resnet50_and_channel_mapper_match_jax():
    rng = np.random.RandomState(0)
    x = rng.randn(2, 64, 96, 3).astype(np.float32)
    jbb = JResNet(arch="resnet50")
    jneck = JChannelMapper(num_inputs=3, out_channels=64, num_outs=4)
    bb_vars = jbb.init(jax.random.key(0), jnp.asarray(x))
    feats = jbb.apply(bb_vars, jnp.asarray(x))
    neck_vars = jneck.init(jax.random.key(1), feats)

    params = perturb({**flatten(bb_vars["params"], "backbone/"),
                      **flatten(neck_vars["params"], "neck/")}, rng, 0.02)
    stats = perturb(flatten(bb_vars["batch_stats"], "backbone/"), rng, 0.1)
    bb_vars = {"params": unflatten(strip(params, "backbone/")),
               "batch_stats": unflatten(strip(stats, "backbone/"))}
    want = jneck.apply({"params": unflatten(strip(params, "neck/"))},
                       jbb.apply(bb_vars, jnp.asarray(x)))

    sd = state_dict_from_jax(params, stats)
    backbone = build_backbone("resnet50")
    neck = ChannelMapper(backbone.num_channels, 64, 4)
    backbone.load_state_dict(strip(sd, "backbone."), strict=True)
    neck.load_state_dict(strip(sd, "neck."), strict=True)
    with torch.no_grad():
        got = neck(backbone(torch.from_numpy(x).permute(0, 3, 1, 2)))
    assert [tuple(g.shape[2:]) for g in got] == [(8, 12), (4, 6), (2, 3), (1, 2)]
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.permute(0, 2, 3, 1).numpy(), np.asarray(w), atol=1e-4)


@pytest.mark.parametrize("ref_dim", [2, 4])
def test_msda_module_matches_jax(ref_dim):
    rng = np.random.RandomState(ref_dim)
    shapes = ((10, 12), (5, 6), (3, 3))
    total = sum(h * w for h, w in shapes)
    bs, nq, c = 2, 19, 64
    query = rng.randn(bs, nq, c).astype(np.float32)
    value = rng.randn(bs, total, c).astype(np.float32)
    ref = rng.uniform(0.05, 0.95, (bs, nq, len(shapes), ref_dim)).astype(np.float32)
    mask = np.zeros((bs, total), bool)
    mask[1, 100:] = True
    jm = JMSDA(embed_dim=c, num_levels=len(shapes), num_heads=4, num_points=3)
    args = (jnp.asarray(query), jnp.asarray(ref), jnp.asarray(value), shapes,
            jnp.asarray(mask))
    params = perturb(flatten(jm.init(jax.random.key(0), *args)["params"]), rng, 0.05)
    want = np.asarray(jm.apply({"params": unflatten(params)}, *args))

    tm = MultiScaleDeformableAttention(c, len(shapes), 4, 3)
    tm.load_state_dict(state_dict_from_jax(params, {}), strict=True)
    with torch.no_grad():
        got = tm(torch.from_numpy(query), torch.from_numpy(ref), torch.from_numpy(value),
                 shapes, torch.from_numpy(mask)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-4)
