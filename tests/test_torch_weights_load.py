"""The port's lenient weight load (``utils/weights.py::load_weights``)
against the JAX package's (``utils/checkpoint.py::load_weights``) on one
file and one model: the tiny config saved at 91 classes by the JAX
package's ``save_weights``, with a q projection, a plain parameter and a
FrozenBN statistic taken out, loaded into the tiny config at 4 classes."""
import sys

import jax
import numpy as np
import pytest
import torch

sys.path.insert(0, ".")
from tools.convert_torch_weights import convert_state_dict  # noqa: E402

from relation_detr_tpu.utils.checkpoint import load_weights as j_load_weights  # noqa: E402
from relation_detr_tpu.utils.checkpoint import save_weights as j_save_weights  # noqa: E402
from relation_detr_tpu_torch.configs.relation_detr import (  # noqa: E402
    relation_detr_resnet50_tiny_test as tiny,
)
from relation_detr_tpu_torch.models.detector import RelationDETR  # noqa: E402
from relation_detr_tpu_torch.utils.weights import (  # noqa: E402
    _param_entry,
    jax_key_label,
    load_weights,
)
from tests.test_torch_modules import unflatten  # noqa: E402


@pytest.fixture(scope="module")
def saved(tmp_path_factory):
    """A 91-class tiny model's weights in a JAX-format file (the path given
    without ``.npz``), and the dropped keys."""
    model = RelationDETR(**dict(tiny.model_args, num_classes=91),
                         generator=torch.Generator().manual_seed(0))
    params, stats, leftover = convert_state_dict(dict(model.state_dict()))
    assert not leftover
    dropped = [next(k for k in params if k.endswith("q_proj/kernel")),
               next(k for k in params if k.endswith("level_embeds")),
               next(k for k in stats if k.endswith("mean"))]
    params = {k: v for k, v in params.items() if k not in dropped}
    stats = {k: v for k, v in stats.items() if k not in dropped}
    path = str(tmp_path_factory.mktemp("weights") / "tiny91")
    j_save_weights(path + ".npz", {"params": unflatten(params),
                                   "batch_stats": unflatten(stats)})
    return path, dropped


def test_lenient_load_matches_jax_load_weights(saved):
    """The same tensors load, are skipped for their shape and are missing as
    in the JAX load_weights with the same file and a 4-class template; every
    loaded tensor equals the file's; the skipped and missing ones keep the
    model's values; strict=True raises and loads nothing."""
    path, dropped = saved
    model = tiny.build_model(device="cpu", seed=1)
    # the JAX template: the 4-class model's variables in the JAX layout
    # (convert_state_dict gives the JAX model's tree exactly:
    # test_torch_detector.py::test_weight_bridge_round_trip)
    params, stats, _ = convert_state_dict(dict(model.state_dict()))
    template = {"params": unflatten(params), "batch_stats": unflatten(stats)}
    jout = j_load_weights(path, template)  # appends .npz, as the port does
    want = {"loaded": set(), "mismatched": set(), "missing": set()}
    with np.load(path + ".npz") as archive:
        files = {k: archive[k] for k in archive.files}
    for (p, leaf), kept in zip(jax.tree_util.tree_flatten_with_path(jout)[0],
                               jax.tree_util.tree_leaves(template)):
        key = "/".join(str(getattr(k, "key", k)) for k in p)
        kind = "loaded" if leaf is not kept else "mismatched" if key in files else "missing"
        want[kind].add(jax_key_label(key))
    assert {jax_key_label(k) for k in ("params/" + dropped[0], "params/" + dropped[1],
                                       "batch_stats/" + dropped[2])} == want["missing"]
    assert any("class_head" in k for k in want["mismatched"])

    before = {k: v.clone() for k, v in model.state_dict().items()}
    with pytest.raises(ValueError, match="strict load failed"):
        load_weights(model, path, strict=True)
    assert all(torch.equal(v, before[k]) for k, v in model.state_dict().items())
    report = load_weights(model, path)
    assert {k: set(v if k != "mismatched" else (m[0] for m in v))
            for k, v in report.items()} == want
    after = model.state_dict()
    for label in report["loaded"]:
        name, part = label.split("[")[0], label[-2] if label.endswith("]") else None
        rows = after[name].shape[0] // 3
        got = after[name] if part is None else after[name][
            "qkv".index(part) * rows:("qkv".index(part) + 1) * rows]
        key = next(k for k in files if jax_key_label(k) == label)
        value = (files[key] if key.startswith("batch_stats/") else
                 _param_entry(key[len("params/"):], files[key])[2])
        assert torch.equal(got, torch.from_numpy(np.ascontiguousarray(value))), label
    for label in report["missing"] + [m[0] for m in report["mismatched"]]:
        name = label.split("[")[0]
        if not label.endswith("]"):
            assert torch.equal(after[name], before[name]), label
