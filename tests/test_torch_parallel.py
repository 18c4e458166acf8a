"""The port's data parallelism on the CPU: two processes under gloo
(``tests/torch_dp_workers.py``; ``torch.multiprocessing.spawn``, a
``file://`` rendezvous in the test's ``tmp_path``, one torch thread each).

(a) A 2-process train step of the tiny model against the JAX package's
``make_train_step`` over a 2-device mesh, same weights, batch and denoising
draws; the two images carry 3 and 17 boxes, so each process pads its own
ground truth to another bucket (16 and 100) than the global batch's (100)
and a process-local ``max_gt`` or ``num_boxes`` would show. (b) The same
2-process step against the one-process step at batch 2, under
accumulation 2 and under remat "none". (c) A group of one process equals
no group, bit for bit. (d) The detection gather: each process's 12 stats
equal the one-process evaluator's and the JAX evaluator's. (e) The train
CLI on 2 processes against one at twice the batch; (f) the processes'
loader shards against the JAX loader's global batches. Tolerances are the
repository's: losses at 1e-4 relative, gradients at 1e-3 of each leaf's
max, parameters after an AdamW update at 1e-6.
"""
import functools
import importlib
import json
import os
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

import torch_dp_workers as workers  # noqa: E402
from relation_detr_tpu.data.loader import DataLoader as JDataLoader  # noqa: E402
from relation_detr_tpu.losses.criterion import CriterionConfig as JCriterionConfig  # noqa: E402
from relation_detr_tpu.models.denoising import GenerateDenoisingQueries as JGenerator  # noqa: E402
from relation_detr_tpu.models.detector import RelationDETR as JRelationDETR  # noqa: E402
from relation_detr_tpu.parallel.mesh import create_mesh  # noqa: E402
from relation_detr_tpu.parallel.train_step import create_train_state  # noqa: E402
from relation_detr_tpu.parallel.train_step import make_train_step as jmake_train_step  # noqa: E402
from relation_detr_tpu.utils.coco_eval import CocoEvaluator as JCocoEvaluator  # noqa: E402
from relation_detr_tpu_torch.configs import build_detector  # noqa: E402
from relation_detr_tpu_torch.data.loader import DataLoader  # noqa: E402
from relation_detr_tpu_torch.parallel import mesh  # noqa: E402
from relation_detr_tpu_torch.utils.coco_eval import CocoEvaluator  # noqa: E402
from relation_detr_tpu_torch.utils.weights import state_dict_from_jax  # noqa: E402
from tests.test_torch_modules import flatten, perturb, unflatten  # noqa: E402

TINY = importlib.import_module(
    "relation_detr_tpu_torch.configs.relation_detr.relation_detr_resnet50_tiny_test")
# 17 boxes tiled 6x for the hybrid set need more than the tiny config's 90 proposals
MODEL_ARGS = dict(TINY.model_args, hybrid_num_proposals=120)
GT_COUNTS = (3, 17)  # GT buckets 16 and 100; the global batch's is 100
H, W = 128, 160
LR = 1e-4
TOL_LOSS = 1e-4  # relative, every loss term
TOL_GRAD = 1e-3  # of each leaf's max |grad|
TOL_PARAM = 1e-6  # absolute, parameters after an AdamW update
QUICK_COMPILE = {"xla_backend_optimization_level": 0, "xla_llvm_disable_expensive_passes": True}
SYNTH = os.path.join(os.path.dirname(__file__), "data", "torch_port", "synth_coco")
TINY_PATH = "relation_detr_tpu_torch/configs/relation_detr/relation_detr_resnet50_tiny_test.py"


def _global_batch(rng, gt_counts=GT_COUNTS, cap=100):
    """A batch in the loader's layout, ground truth padded to ``cap``."""
    bs = len(gt_counts)
    images = rng.randn(bs, H, W, 3).astype(np.float32)
    mask = np.zeros((bs, H, W), bool)
    mask[-1, 96:] = True
    mask[-1, :, 120:] = True
    images[mask] = 0.0
    labels = np.full((bs, cap), -1, np.int64)
    boxes = np.zeros((bs, cap, 4), np.float32)
    valid = np.zeros((bs, cap), bool)
    for b, n in enumerate(gt_counts):
        labels[b, :n] = rng.randint(0, TINY.num_classes, n)
        boxes[b, :n] = np.concatenate([rng.uniform(0.25, 0.75, (n, 2)),
                                       rng.uniform(0.05, 0.3, (n, 2))], 1)
        valid[b, :n] = True
    return {"images": images, "mask": mask, "gt_labels": labels, "gt_boxes": boxes,
            "gt_valid": valid}


def _draws(rng, bs, dn_cap):
    return {"flip_u": rng.rand(bs, dn_cap).astype(np.float32),
            "random_labels": rng.randint(0, TINY.num_classes, (bs, dn_cap)),
            "rand_sign": rng.choice([-1.0, 1.0], (bs, dn_cap, 4)).astype(np.float32),
            "rand_part": rng.rand(bs, dn_cap, 4).astype(np.float32)}


@functools.lru_cache(maxsize=None)
def _state(seed=0):
    """The tiny model's weights with offsets on every non-backbone weight
    (as ``tests/test_torch_train.py`` takes them)."""
    model = build_detector(MODEL_ARGS, "cpu", seed)
    rng = np.random.RandomState(31)
    sd = {k: v.numpy() for k, v in model.state_dict().items()}
    noisy = perturb({k: v for k, v in sd.items()
                     if not k.startswith("backbone.") or "bn" in k or "downsample.1" in k},
                    rng, 0.02)
    return {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in {**sd, **noisy}.items()}


def _spec(steps, **extra):
    return dict(model_args=MODEL_ARGS, criterion_args=TINY.criterion_args,
                hybrid_assign=TINY.hybrid_assign, lr=LR, state=_state(), steps=steps, **extra)


def _one_process(spec):
    """The same steps in this process, no group, at the global batch."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    torch.use_deterministic_algorithms(True)
    try:
        return workers.run_steps(spec)
    finally:
        torch.use_deterministic_algorithms(False)
        torch.set_num_threads(threads)


def _assert_losses(got, want, what):
    assert set(want) <= set(got), sorted(set(want) - set(got))
    for k, w in want.items():
        np.testing.assert_allclose(got[k], float(w), rtol=TOL_LOSS, atol=1e-7,
                                   err_msg=f"{what}: {k}")


def _assert_grads(got, want, what):
    assert set(got) == set(want), sorted(set(got) ^ set(want))[:8]
    for name, w in want.items():
        w = np.asarray(w)
        scale = float(np.abs(w).max())
        np.testing.assert_allclose(got[name].numpy(), w, rtol=0, atol=TOL_GRAD * scale + 1e-12,
                                   err_msg=f"{what}: {name}")


def _jax_step(spec, batch, draws):
    """The JAX package's train step over a 2-device mesh, with an optax
    transformation that keeps the gradients as its state (and updates
    nothing): returns the metrics and the global batch's gradients."""
    params, stats, leftover = convert_state_dict(dict(spec["state"]))
    assert not leftover, leftover[:8]
    keep_grads = optax.GradientTransformation(
        lambda p: jax.tree.map(jnp.zeros_like, p),
        lambda g, s, p=None: (jax.tree.map(jnp.zeros_like, g), g))
    jmesh = create_mesh(jax.devices()[:2])
    jmodel = JRelationDETR(**MODEL_ARGS)
    state = create_train_state({"params": unflatten(params), "batch_stats": unflatten(stats)},
                               keep_grads, jmesh)
    step = jmake_train_step(jmodel, JCriterionConfig(**TINY.criterion_args), keep_grads, jmesh,
                            hybrid_assign=TINY.hybrid_assign, donate=False)
    jbatch = {k: jnp.asarray(v, jnp.int32) if k == "gt_labels" else jnp.asarray(v)
              for k, v in batch.items()}
    jdraws = {k: jnp.asarray(v) for k, v in draws.items()}

    def inject(next_fun, args, kwargs, context):
        if isinstance(context.module, JGenerator) and context.method_name == "__call__":
            kwargs = {**kwargs, "noise_draws": jdraws}
        return next_fun(*args, **kwargs)

    rng = jax.random.key(0)
    with nn.intercept_methods(inject):
        compiled = step.lower(state, jbatch, rng).compile(QUICK_COMPILE)
    new_state, metrics = compiled(state, jbatch, rng)
    return ({k: float(v) for k, v in metrics.items()},
            state_dict_from_jax(flatten(new_state.opt_state), {}))


def _step_specs():
    """(a)'s spec (one step, no clip) and (b)'s (the clip on): accumulation
    2 over two global batches, and remat "none"."""
    rng = np.random.RandomState(6)
    dn_cap = 2 * MODEL_ARGS["denoising_nums"]
    batch, draws = _global_batch(rng), _draws(rng, 2, dn_cap)
    specs = {"jax": _spec([(batch, draws)], max_norm=float("inf"))}
    rng = np.random.RandomState(7)
    steps = [(_global_batch(rng, counts), _draws(rng, 2, dn_cap))
             for counts in ((3, 17), (5, 2))]
    specs["accumulate_2"] = _spec(steps, accumulate=2)
    specs["remat_none"] = _spec(steps[:1], remat="none")
    return specs


@pytest.fixture(scope="module")
def runs(coco, tmp_path_factory):
    """Every 2-process job in one pair of processes, and the one-process
    references in a third process (a group of one, which is no group bit
    for bit: test (c)), all started first; the JAX mesh step and the
    evaluators run here meanwhile."""
    tmp = tmp_path_factory.mktemp("runs")
    specs = _step_specs()
    ann_file = os.path.join(SYNTH, "annotations", "instances_val2017.json")
    dets = _detections(ann_file, 3)
    names = list(specs) + ["gather", "train_cli", "eval_cli"]
    spawned = workers.Spawned([("steps", specs[k]) for k in specs] + [
        ("gather", {"ann_file": ann_file, "dets": dets}),
        ("train_cli", {"args": _train_args(coco, tmp / "two", 1)}),
        ("eval_cli", {"args": _eval_args(coco, tmp / "two.json")})], tmp / "two_processes")
    ref_names = ["accumulate_2", "remat_none", "train_cli", "eval_cli"]
    alone = workers.Spawned([("steps", specs["accumulate_2"]), ("steps", specs["remat_none"]),
                             ("train_cli", {"args": _train_args(coco, tmp / "one", 2)}),
                             ("eval_cli", {"args": _eval_args(coco, tmp / "one.json")})],
                            tmp / "one_process", world=1)
    spec = specs["jax"]
    ref = {"jax": _jax_step(spec, *spec["steps"][0]), "stats": []}
    for ev in (CocoEvaluator(ann_file), JCocoEvaluator(ann_file)):
        for img_id, boxes, scores, labels in dets:
            ev.update_from_arrays(img_id, boxes, scores, labels, skip_if_seen=True)
        ref["stats"].append(ev.accumulate_and_summarize(verbose=False))
    ref.update({k: r[0] for k, r in zip(ref_names, alone.join())})
    got = dict(zip(names, spawned.join()))
    return dict(specs=specs, ref=ref, got=got, dets=dets, tmp=tmp)


def test_two_process_step_matches_jax_mesh_step(runs):
    """(a) Each process's metrics (every loss term, the total and
    ``grad_norm``) are the JAX mesh step's over the global batch, and the
    gradients both processes step on are the JAX step's (over the leaves the
    port trains; the JAX norm taken over the same leaves). The processes'
    own ground truth sits in buckets 16 and 100."""
    ranks, batch = runs["got"]["jax"], runs["specs"]["jax"]["steps"][0][0]
    jmetrics, jgrads = runs["ref"]["jax"]
    per_rank = [workers.rank_batch(batch, r, 2)["gt_valid"].shape[1] for r in range(2)]
    assert per_rank == [16, 100]
    trainable = set(ranks[0]["updates"][0])
    want = {n: g.numpy() for n, g in jgrads.items() if n in trainable}
    want_norm = float(np.sqrt(sum(float((g.astype(np.float64) ** 2).sum())
                                  for g in want.values())))
    for r, out in enumerate(ranks):
        got = out["metrics"][0]
        assert got["nonfinite_count"] == 0
        _assert_losses(got, {k: v for k, v in jmetrics.items() if k.startswith("loss")
                             or k == "total_loss"}, f"rank {r}")
        np.testing.assert_allclose(got["grad_norm"], want_norm, rtol=TOL_LOSS)
        _assert_grads(out["updates"][0], want, f"rank {r}")
    assert len(trainable) > 100


def test_group_counts_reach_the_denoising_layout():
    """(a) The CDN layout follows the global batch: at ``max_gt`` 17 the 10
    slots are all first-group positives of the first image's 3 boxes and
    padding; rank 0's own ``max_gt`` (3) would have given a negative half."""
    from relation_detr_tpu_torch.models.denoising import GenerateCDNQueries

    gen = GenerateCDNQueries(TINY.num_classes, 16, MODEL_ARGS["denoising_nums"])
    batch, draws = _step_specs()["jax"]["steps"][0]
    part = workers.rank_batch(batch, 0, 2)
    draws = {k: torch.from_numpy(v[:1]) for k, v in draws.items()}
    args = (part["gt_labels"], part["gt_boxes"], part["gt_valid"], 60)
    meta = gen(*args, noise_draws=draws, max_gt=torch.tensor(17))[3]
    local = gen(*args, noise_draws=draws)[3]
    assert int(meta.max_gt) == 17 and int(meta.groups) == 1
    assert meta.dn_positive[0].tolist() == [True] * 3 + [False] * 7
    assert int(local.max_gt) == 3 and int(local.dn_valid[0].sum()) == 6


@pytest.mark.parametrize("case", ["accumulate_2", "remat_none"])
def test_two_process_steps_match_one_process(runs, case):
    """(b) Two processes at batch 1 against one at batch 2 over the same
    global batches, draws and weights, with the clip on: every step's
    metrics, the gradients of every update, and the parameters after it.
    Under accumulation 2, two micro-steps make one update; under remat
    "none" each transformer layer is recomputed in the backward."""
    ranks, alone = runs["got"][case], runs["ref"][case]
    n_steps = len(runs["specs"][case]["steps"])
    assert len(alone["updates"]) == 1 and len(alone["metrics"]) == n_steps
    for r, out in enumerate(ranks):
        for got, want in zip(out["metrics"], alone["metrics"]):
            _assert_losses(got, {k: v for k, v in want.items() if k.startswith("loss")
                                 or k in ("total_loss", "grad_norm")}, f"rank {r}")
        _assert_grads(out["updates"][0], {n: g.numpy() for n, g in alone["updates"][0].items()},
                      f"rank {r}")
        for name, p in alone["params"].items():
            np.testing.assert_allclose(out["params"][name].numpy(), p.numpy(), rtol=0,
                                       atol=TOL_PARAM, err_msg=f"rank {r}: {name}")
        assert len(out["reduce_ms"]) == n_steps
    for name, p in ranks[0]["params"].items():  # the processes hold equal parameters
        assert torch.equal(p, ranks[1]["params"][name]), name


def test_group_of_one_equals_no_group(tmp_path):
    """(c) A gloo group of one process runs no collective: two steps give
    the metrics and parameters of the same steps without a group, bit for
    bit."""
    rng = np.random.RandomState(9)
    steps = [(_global_batch(rng, (3,)), _draws(rng, 1, 2 * MODEL_ARGS["denoising_nums"]))
             for _ in range(2)]
    spec = _spec(steps)
    alone = _one_process(spec)
    assert not mesh.initialized()
    mesh.init_distributed("gloo", "cpu", init_method=f"file://{tmp_path}/rendezvous", rank=0,
                          world_size=1, timeout_s=60)
    try:
        assert mesh.world() == (0, 1) and not mesh.active()
        grouped = _one_process(spec)
    finally:
        mesh.destroy()
    assert grouped["metrics"] == alone["metrics"]
    assert grouped["reduce_ms"] == []
    for name, p in alone["params"].items():
        assert torch.equal(grouped["params"][name], p), name


def _detections(ann_file, seed):
    """Per image: jittered copies of its boxes and random boxes with
    scores, xyxy in pixels (as post_process gives)."""
    with open(ann_file) as f:
        coco = json.load(f)
    rng = np.random.RandomState(seed)
    cats = [c["id"] for c in coco["categories"]]
    out = []
    for img in coco["images"]:
        gts = np.asarray([a["bbox"] for a in coco["annotations"] if a["image_id"] == img["id"]],
                         np.float64).reshape(-1, 4)
        xyxy = np.concatenate([gts[:, :2], gts[:, :2] + gts[:, 2:]], 1)
        xyxy = xyxy + rng.randn(*xyxy.shape) * 2.0
        extra = rng.uniform(0, min(img["width"], img["height"]) / 2, (5, 2))
        extra = np.concatenate([extra, extra + rng.uniform(5, 40, (5, 2))], 1)
        boxes = np.concatenate([xyxy, extra]).astype(np.float32)
        scores = rng.uniform(0.05, 1.0, len(boxes)).astype(np.float32)
        labels = rng.choice(cats, len(boxes)).astype(np.int64)
        out.append((img["id"], boxes, scores, labels))
    return out


def test_detection_gather_matches_one_process_and_jax(runs):
    """(d) Each process adds every other image's detections (process 1 also
    a perturbed copy of image 0, as the loader's wraparound repeats a
    batch); after the gather both hold every image, with image 0 as process
    0 found it, and their 12 stats equal the one-process evaluator's and the
    JAX evaluator's over the committed val split."""
    stats = runs["ref"]["stats"]
    assert stats[0] == stats[1]
    for out in runs["got"]["gather"]:
        assert out["images"] == len(runs["dets"]) == 8
        assert out["stats"] == stats[0]
    assert 0.0 < stats[0]["AP"] < 1.0


@pytest.fixture(scope="module")
def coco(tmp_path_factory):
    """The first 4 committed train images as a train and a val split, and
    a train config with canvas buckets for the tiny config's eval sizes."""
    root = tmp_path_factory.mktemp("coco")
    with open(root / "train_config.py", "w") as f:
        f.write("from relation_detr_tpu_torch.configs.train_config import *  # noqa\n"
                "eval_buckets = ((224, 320), (320, 224), (320, 320))\n")
    with open(os.path.join(SYNTH, "annotations", "instances_train2017.json")) as f:
        split = json.load(f)
    split["images"] = split["images"][:4]
    keep = {i["id"] for i in split["images"]}
    split["annotations"] = [a for a in split["annotations"] if a["image_id"] in keep]
    os.makedirs(root / "annotations")
    for name in ("train2017", "val2017"):
        os.symlink(os.path.join(SYNTH, "train2017"), root / name)
        with open(root / "annotations" / f"instances_{name}.json", "w") as f:
            json.dump(split, f)
    return str(root)


def _train_args(coco, out, batch):
    return ["--config-file", os.path.join(coco, "train_config.py"), "--model-config",
            TINY_PATH, "--coco-path", coco, "--output-dir", str(out), "--num-epochs", "1",
            "--batch-size", str(batch), "--canvas", "160,224", "--eval-every-epochs", "1",
            "--seed", "3", "--device", "cpu"]


def test_train_cli_two_processes_match_one_at_twice_the_batch(runs):
    """(e) ``train.main`` on 2 processes at batch 1 for an epoch of 4 images
    (2 steps each) with an evaluation: the final weights equal one
    process's at batch 2 (the same images a step, the same denoising
    draws), one checkpoint and one ``latest.npz`` are written (by process
    0), and both processes see the same stats."""
    ranks, alone, tmp = runs["got"]["train_cli"], runs["ref"]["train_cli"], runs["tmp"]
    assert [r["images"] for r in ranks] == [2, 2] and alone["images"] == 4
    assert ranks[0]["evals"] == ranks[1]["evals"] and len(ranks[0]["evals"]) == 1
    assert ranks[0]["metrics"] == ranks[1]["metrics"]
    _assert_losses(ranks[0]["metrics"], {k: v for k, v in alone["metrics"].items()
                                         if k.startswith("loss") or k == "total_loss"},
                   "last step")
    assert sorted(os.listdir(tmp / "two" / "checkpoints")) == ["0.pt"]
    assert sorted(f for f in os.listdir(tmp / "two") if f.endswith(".npz")) == \
        sorted(f for f in os.listdir(tmp / "one") if f.endswith(".npz"))
    got = np.load(tmp / "two" / "latest.npz")
    want = np.load(tmp / "one" / "latest.npz")
    assert sorted(got.files) == sorted(want.files)
    for key in want.files:
        np.testing.assert_allclose(got[key], want[key], rtol=0, atol=TOL_PARAM, err_msg=key)


def _eval_args(coco, result_json):
    return ["--coco-path", coco, "--model-config", TINY_PATH, "--batch-size", "1",
            "--result-json", str(result_json), "--device", "cpu"]


def test_eval_cli_two_processes_match_one(runs):
    """The eval CLI on 2 processes over the 4-image split (each evaluates
    every other batch): both print the one-process run's 12 stats, and
    process 0 alone writes a result JSON holding every image's predictions,
    the one-process file's."""
    ranks, alone, tmp = runs["got"]["eval_cli"], runs["ref"]["eval_cli"], runs["tmp"]
    assert [r["images"] for r in ranks] == [2, 2] and alone["images"] == 4
    for out in ranks:
        assert out["stats"] == alone["stats"]
    with open(tmp / "two.json") as f:
        got = json.load(f)
    with open(tmp / "one.json") as f:
        want = json.load(f)

    def key(p):
        return (p["image_id"], p["category_id"], -p["score"], p["bbox"])

    assert len(got) == 4 * TINY.select_box_nums_for_evaluation
    assert sorted(got, key=key) == sorted(want, key=key)


@pytest.mark.parametrize("world,batch", [(2, 1), (2, 2), (4, 1)])
def test_loader_shards_union_to_jax_global_batches(world, batch):
    """(f) With a fixed canvas, the processes' step-i batches (each
    ``batch`` images) together are the JAX loader's global batch i of
    ``world * batch`` images, over two shuffled epochs: the same images in
    the same order; ground truth equal up to each process's own capacity
    bucket."""
    rng = np.random.RandomState(world * 10 + batch)
    samples = []
    for i in range(16):
        n = int(rng.choice([1, 3, 20]))
        xy = rng.uniform(0, 40, (n, 2))
        samples.append({"image": rng.randint(0, 256, (48, 64, 3)).astype(np.uint8),
                        "boxes": np.concatenate([xy, xy + rng.uniform(4, 20, (n, 2))],
                                                1).astype(np.float32),
                        "labels": rng.randint(0, 5, n), "image_id": i,
                        "orig_size": np.asarray([48, 64])})
    common = dict(shuffle=True, seed=4, num_workers=1, fixed_canvas=(64, 64), drop_last=True)
    jax_loader = JDataLoader(samples, batch_size=world * batch, process_index=0,
                             process_count=1, **common)
    shards = [DataLoader(samples, batch_size=batch, process_index=r, process_count=world,
                         **common) for r in range(world)]
    for _ in range(2):
        want = list(jax_loader)
        got = [list(shard) for shard in shards]
        assert all(len(g) == len(want) for g in got)
        for i, global_batch in enumerate(want):
            parts = [g[i] for g in got]
            np.testing.assert_array_equal(np.concatenate([p["image_ids"] for p in parts]),
                                          global_batch["image_ids"])
            np.testing.assert_array_equal(np.concatenate([p["images"] for p in parts]),
                                          global_batch["images"])
            for key in ("gt_valid", "gt_boxes", "gt_labels"):
                cap = global_batch[key].shape[1]
                padded = []
                for p in parts:
                    pad = [(0, 0), (0, cap - p[key].shape[1])] + [(0, 0)] * (p[key].ndim - 2)
                    padded.append(np.pad(p[key], pad, constant_values=-1 if key == "gt_labels"
                                         else 0))
                np.testing.assert_array_equal(np.concatenate(padded), global_batch[key], key)
