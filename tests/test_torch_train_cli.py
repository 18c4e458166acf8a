"""The port's train CLI (``relation_detr_tpu_torch/train.py``) on the CPU.

The tiny-test config over a 4-image subset of the committed synthetic train
split (``tests/data/torch_port/synth_coco``), at a small fixed canvas, with
gradient accumulation, an EMA and an evaluation each epoch (over the same 4
images as a val split), decoded by cv2 (the CPU has no JPEG decoder). Two
epochs straight must write a ``latest.npz``, a ``latest_ema.npz`` and a
last state file bit-identical to one epoch followed by ``--resume`` for the
second; the weight files load into the JAX package's tiny model with
nothing missing or mismatched. The runs use torch's deterministic
algorithms: the plain MSDA's backward accumulates the value gradient with
``index_put_``, whose multi-threaded CPU kernel adds in a varying order.
They run torch on one thread: beside other test processes on the same
cores, torch's thread pool over thousands of small ops slows tenfold.
Evaluation canvases are the tiny config's own sizes (``eval_buckets`` of
a config file that extends the port's train config). The bf16 policy with
the "dots" remat policy resumes bit-identically too.
"""
import json
import os
import sys

import cv2
import jax
import numpy as np
import pytest
import torch

sys.path.insert(0, ".")
from relation_detr_tpu.models.detector import RelationDETR as JRelationDETR  # noqa: E402
from relation_detr_tpu.utils.checkpoint import load_weights as jax_load_weights  # noqa: E402
from relation_detr_tpu_torch import train  # noqa: E402
from relation_detr_tpu_torch.utils.checkpoint import CheckpointManager  # noqa: E402

SYNTH = os.path.join(os.path.dirname(__file__), "data", "torch_port", "synth_coco")
TINY = "relation_detr_tpu_torch/configs/relation_detr/relation_detr_resnet50_tiny_test.py"
IMAGES = 4


def cv2_decode(data):
    return cv2.cvtColor(cv2.imdecode(data, cv2.IMREAD_COLOR), cv2.COLOR_BGR2RGB)


@pytest.fixture(scope="module")
def coco(tmp_path_factory):
    """The first 4 train images as a train and a val split, and a train
    config (``<root>/train_config.py``) with canvas buckets for the tiny
    config's eval sizes (224 / 320)."""
    root = tmp_path_factory.mktemp("coco")
    with open(root / "train_config.py", "w") as f:
        f.write("from relation_detr_tpu_torch.configs.train_config import *  # noqa\n"
                "eval_buckets = ((224, 320), (320, 224), (320, 320))\n")
    with open(os.path.join(SYNTH, "annotations", "instances_train2017.json")) as f:
        split = json.load(f)
    split["images"] = split["images"][:IMAGES]
    keep = {i["id"] for i in split["images"]}
    split["annotations"] = [a for a in split["annotations"] if a["image_id"] in keep]
    os.makedirs(root / "annotations")
    for name in ("train2017", "val2017"):
        os.symlink(os.path.join(SYNTH, "train2017"), root / name)
        with open(root / "annotations" / f"instances_{name}.json", "w") as f:
            json.dump(split, f)
    return str(root)


def _args(coco, out, epochs, *extra):
    return ["--config-file", os.path.join(coco, "train_config.py"), "--model-config", TINY,
            "--coco-path", coco, "--output-dir", str(out),
            "--num-epochs", str(epochs), "--batch-size", "1", "--canvas", "160,224",
            "--accumulate-steps", "2", "--ema-decay", "0.9", "--eval-every-epochs", "1",
            "--seed", "3", "--device", "cpu", *extra]


@pytest.fixture(scope="module")
def runs(coco, tmp_path_factory):
    straight = tmp_path_factory.mktemp("straight")
    first = tmp_path_factory.mktemp("first")
    resumed = tmp_path_factory.mktemp("resumed")
    deterministic, threads = torch.are_deterministic_algorithms_enabled(), torch.get_num_threads()
    torch.use_deterministic_algorithms(True)
    torch.set_num_threads(1)
    try:
        return {
            "straight": (straight, train.main(_args(coco, straight, 2), decode=cv2_decode)),
            "first": (first, train.main(_args(coco, first, 1), decode=cv2_decode)),
            "resumed": (resumed, train.main(_args(coco, resumed, 2, "--resume", str(first)),
                                            decode=cv2_decode)),
        }
    finally:
        torch.use_deterministic_algorithms(deterministic)
        torch.set_num_threads(threads)


def _npz(path):
    with np.load(path) as f:
        return {k: f[k] for k in f.files}


def test_two_epochs_equal_one_epoch_and_a_resume(runs):
    """latest.npz, latest_ema.npz and the last state file of 2 epochs
    straight equal those of 1 epoch + ``--resume`` of it, bit for bit; the
    resumed run trained epoch 1 only (4 images at B=1: 4 micro-steps and 2
    updates an epoch) at the same lrs; both evaluated epoch 1 alike; the EMA
    is not the weights."""
    (straight, a), (_, first), (resumed, b) = runs["straight"], runs["first"], runs["resumed"]
    assert len(a["steps"]) == 8 and len(first["steps"]) == 4 and len(b["steps"]) == 4
    assert len(a["lrs"]) == 4 and a["lrs"][2:] == b["lrs"]
    for name in ("latest.npz", "latest_ema.npz"):
        want, got = _npz(straight / name), _npz(resumed / name)
        assert sorted(want) == sorted(got)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=f"{name} {k}")
    latest, ema = _npz(straight / "latest.npz"), _npz(straight / "latest_ema.npz")
    assert any(not np.array_equal(latest[k], ema[k]) for k in latest if k.startswith("params/"))
    want = CheckpointManager(straight / "checkpoints").restore()
    got = CheckpointManager(resumed / "checkpoints").restore()
    assert want["epoch"] == got["epoch"] == 1 and want["loader_epoch"] == 2
    assert want["train_step"]["state"] == got["train_step"]["state"]
    assert want["train_step"]["state"]["updates"] == 4
    for key in ("model", "ema"):
        for k, v in want[key].items():
            assert torch.equal(got[key][k], v), (key, k)
    for k in want["train_step"]["accumulator"]:
        assert torch.equal(got["train_step"]["accumulator"][k],
                           want["train_step"]["accumulator"][k]), k
    for (_, s1), (_, s2) in zip(sorted(want["optimizer"]["state"].items()),
                                sorted(got["optimizer"]["state"].items())):
        for k in s1:
            assert torch.equal(s1[k], s2[k]), k
    assert [e["epoch"] for e in a["evals"]] == [0, 1] and [e["epoch"] for e in b["evals"]] == [1]
    assert a["evals"][1]["stats"] == b["evals"][0]["stats"]
    assert os.path.isfile(a["paths"]["best_ap50"]) or os.path.isfile(a["paths"]["best_ap"])


def test_latest_weights_load_into_the_jax_model(runs):
    """The CLI's latest.npz read by the JAX package's ``load_weights`` into
    the tiny model's variables: nothing missing, nothing mismatched (the
    lenient load warns on either; strict raises)."""
    straight, _ = runs["straight"]
    jmodel = JRelationDETR(num_classes=4, num_queries=60, hybrid_num_proposals=90,
                           denoising_nums=5, transformer_enc_layers=1,
                           transformer_dec_layers=2, backbone_arch="resnet18")
    key = jax.random.key(0)
    variables = jax.eval_shape(lambda: jmodel.init(
        {"params": key, "denoising": key}, np.zeros((1, 128, 128, 3), np.float32),
        np.zeros((1, 128, 128), bool), np.zeros((1, 2), np.int32),
        np.full((1, 2, 4), 0.5, np.float32), np.ones((1, 2), bool), train=True))
    template = {k: jax.tree.map(lambda s: np.zeros(s.shape, s.dtype), v)
                for k, v in variables.items()}
    loaded = jax_load_weights(str(straight / "latest.npz"), template, strict=True)
    flat = _npz(straight / "latest.npz")
    leaves = jax.tree_util.tree_flatten_with_path(loaded)[0]
    assert len(leaves) == len(flat)
    for path, leaf in leaves:
        key = "/".join(str(getattr(k, "key", k)) for k in path)
        np.testing.assert_array_equal(np.asarray(leaf), flat[key], err_msg=key)


def test_not_ported_flags_raise(coco, runs, tmp_path):
    """--clamp-check on and --msda-dtype bf16, once refused, set what the
    JAX package's flags set and train (torch on one thread), fine-tuning
    the straight run's weights for a step: the clamp gate, forced,
    measures the loaded weights on the first image."""
    from relation_detr_tpu.ops import msda as jmsda
    from relation_detr_tpu_torch.ops import msda

    weights = str(runs["straight"][0] / "latest.npz")
    args = _args(coco, tmp_path, 1, "--resume", weights, "--max-steps", "1",
                 "--eval-every-epochs", "0", "--clamp-check", "on", "--msda-dtype", "bf16")
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    with msda.msda_defaults(), jmsda.msda_defaults():
        jmsda.apply_msda_cli_flags(train.parse_args(args))
        try:
            got = train.main(args, decode=cv2_decode)
        finally:
            torch.set_num_threads(threads)
        assert jmsda._MSDA_DEFAULTS["tiled_dtype"] == jax.numpy.bfloat16
        assert msda._MSDA_DEFAULTS["tiled_dtype"] == torch.bfloat16
    assert np.isfinite(got["metrics"]["total_loss"])
    assert got["clamp"]["fractions"]


def _bf16_args(coco, out, epochs, *extra):
    """B=2 over the 4 images: 2 steps an epoch, each its own update; no
    evaluation."""
    return ["--config-file", os.path.join(coco, "train_config.py"), "--model-config", TINY,
            "--coco-path", coco, "--output-dir", str(out), "--num-epochs", str(epochs),
            "--batch-size", "2", "--canvas", "160,224", "--ema-decay", "0.9",
            "--mixed-precision", "bf16", "--remat-policy", "dots", "--seed", "5",
            "--device", "cpu", *extra]


def test_bf16_dots_run_resumes_bit_identically(coco, tmp_path):
    """``--mixed-precision bf16 --remat-policy dots``: 2 epochs of 2 steps
    straight and 1 epoch + ``--resume`` for the second write the same
    latest.npz, latest_ema.npz and state file, bit for bit; the weights stay
    fp32 with the fp32 model's names; the state file records bf16, and a
    resume of it without the flag raises."""
    straight, first, resumed = tmp_path / "straight", tmp_path / "first", tmp_path / "resumed"
    deterministic, threads = torch.are_deterministic_algorithms_enabled(), torch.get_num_threads()
    torch.use_deterministic_algorithms(True)
    torch.set_num_threads(1)
    try:
        a = train.main(_bf16_args(coco, straight, 2), decode=cv2_decode)
        train.main(_bf16_args(coco, first, 1), decode=cv2_decode)
        b = train.main(_bf16_args(coco, resumed, 2, "--resume", str(first)), decode=cv2_decode)
        fp32_args = [x for x in _bf16_args(coco, tmp_path / "fp32", 2, "--resume", str(first))
                     if x not in ("--mixed-precision", "bf16")]
        with pytest.raises(ValueError, match="--mixed-precision bf16"):
            train.main(fp32_args, decode=cv2_decode)
    finally:
        torch.use_deterministic_algorithms(deterministic)
        torch.set_num_threads(threads)
    assert len(a["steps"]) == 4 and len(b["steps"]) == 2 and a["lrs"][2:] == b["lrs"]
    assert all(np.isfinite(s["total_loss"]) for s in a["steps"])
    for name in ("latest.npz", "latest_ema.npz"):
        want, got = _npz(straight / name), _npz(resumed / name)
        assert sorted(want) == sorted(got)
        for k in want:
            assert want[k].dtype == np.float32, (name, k)
            np.testing.assert_array_equal(got[k], want[k], err_msg=f"{name} {k}")
    want = CheckpointManager(straight / "checkpoints").restore()
    got = CheckpointManager(resumed / "checkpoints").restore()
    assert want["mixed_precision"] == got["mixed_precision"] == "bf16"
    assert want["train_step"]["state"] == got["train_step"]["state"]
    fp32 = train.Config(train._repo_path(TINY)).build_model(device="cpu")
    assert {k: v.dtype for k, v in want["model"].items()} == \
        {k: v.dtype for k, v in fp32.state_dict().items()}
    for key in ("model", "ema"):
        for k, v in want[key].items():
            assert torch.equal(got[key][k], v), (key, k)
    for (_, s1), (_, s2) in zip(sorted(want["optimizer"]["state"].items()),
                                sorted(got["optimizer"]["state"].items())):
        for k in s1:
            assert torch.equal(s1[k], s2[k]), k
