"""The port's training loop pieces against the JAX package, on the same
numpy-seeded inputs: the ``detr`` train preset (and cv2's INTER_LINEAR
resize it ports), the loader's per-sample generators and
``device_prefetch`` on the CPU, gradient accumulation against
``optax.MultiSteps``, the EMA, the weight file in the JAX layout, and the
checkpoint manager. torch runs on one thread here: beside other test
processes on the same cores, its thread pool over the train step's
thousands of small ops slows tenfold.
"""
import math
import os
import random
import sys

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

sys.path.insert(0, ".")
from tools.convert_torch_weights import convert_state_dict  # noqa: E402

from relation_detr_tpu.data import transforms as jtransforms  # noqa: E402
from relation_detr_tpu.models.detector import RelationDETR as JRelationDETR  # noqa: E402
from relation_detr_tpu.utils import param_groups as jpg  # noqa: E402
from relation_detr_tpu.utils.checkpoint import load_weights as jax_load_weights  # noqa: E402
from relation_detr_tpu.utils.class_names import encode_labels as jencode  # noqa: E402
from relation_detr_tpu.utils.ema import ema_update as jema_update  # noqa: E402
from relation_detr_tpu_torch.data import transforms  # noqa: E402
from relation_detr_tpu_torch.data.coco import CocoDetection  # noqa: E402
from relation_detr_tpu_torch.data.loader import DataLoader, device_prefetch  # noqa: E402
from relation_detr_tpu_torch.parallel.train_step import (  # noqa: E402
    BATCH_KEYS,
    TrainState,
    accumulate,
    make_train_step,
)
from relation_detr_tpu_torch.utils import param_groups as tpg  # noqa: E402
from relation_detr_tpu_torch.utils.checkpoint import CheckpointManager  # noqa: E402
from relation_detr_tpu_torch.utils.class_names import (  # noqa: E402
    decode_labels,
    encode_labels,
    load_class_names,
)
from relation_detr_tpu_torch.utils.ema import ema_init, ema_update  # noqa: E402
from relation_detr_tpu_torch.utils.weights import (  # noqa: E402
    load_weights,
    save_weights,
    state_dict_from_jax,
)
from tests.test_torch_modules import flatten, unflatten  # noqa: E402
from tests.test_torch_train import TINY, _small_batch  # noqa: E402

SYNTH = os.path.join(os.path.dirname(__file__), "data", "torch_port", "synth_coco")
PRESET_SEEDS = (0, 1, 2)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def cv2_decode(data):
    return cv2.cvtColor(cv2.imdecode(data, cv2.IMREAD_COLOR), cv2.COLOR_BGR2RGB)


def _train_split(transforms_=None):
    return CocoDetection(os.path.join(SYNTH, "train2017"),
                         os.path.join(SYNTH, "annotations", "instances_train2017.json"),
                         transforms_, train=True, device="cpu", decode=cv2_decode)


@pytest.mark.parametrize("channels", [3, 1])
def test_resize_linear_is_cv2_inter_linear(channels):
    """``resize_linear`` gives cv2.resize(INTER_LINEAR)'s bytes on uint8
    images, up and down (0.3x-2.5x, exact 2x included), 3 and 1 channels."""
    rng = np.random.RandomState(channels)
    cases = [(400, 600, 200, 300), (5, 7, 3, 4), (2, 2, 1, 1)]
    for _ in range(12):
        h, w = rng.randint(20, 400), rng.randint(20, 500)
        s = rng.uniform(0.3, 2.5)
        cases.append((h, w, max(int(h * s), 1), max(int(w * s * rng.uniform(0.9, 1.1)), 1)))
    for h, w, oh, ow in cases:
        shape = (h, w, 3) if channels == 3 else (h, w)
        img = rng.randint(0, 256, shape, np.uint8)
        want = cv2.resize(img, (ow, oh), interpolation=cv2.INTER_LINEAR)
        np.testing.assert_array_equal(transforms.resize_linear(img, oh, ow), want,
                                      err_msg=str((h, w, oh, ow)))


def test_detr_preset_matches_jax(monkeypatch):
    """The port's ``DetrPreset`` against the JAX one (cv2) on the committed
    train split's 16 images, for 3 generator states given to both: the same
    draws (the generators end in the same state), image sizes, labels and
    crops exact, boxes within 1e-4 px, pixels before normalisation within 1
    level, mean at most 0.15 (``resize_linear`` is cv2's; measured 0)."""
    monkeypatch.setattr(jtransforms, "normalize", lambda sample: sample)
    dataset = _train_split()
    jpreset = jtransforms.DetrPreset()
    preset = transforms.DetrPreset(normalize_host=False)
    branches, diffs = set(), []
    for seed in PRESET_SEEDS:
        for index in range(len(dataset)):
            raw = dataset[index]
            jpreset.rng = random.Random(seed * 1000 + index)
            rng = random.Random(seed * 1000 + index)
            want = jpreset({**raw, "image": raw["image"].copy()})
            got = preset(raw, rng)
            assert rng.getstate() == jpreset.rng.getstate()
            assert got["image"].shape == want["image"].shape and got["image"].dtype == np.uint8
            np.testing.assert_array_equal(got["labels"], want["labels"])
            np.testing.assert_allclose(got["boxes"], want["boxes"], rtol=0, atol=1e-4)
            diff = np.abs(got["image"].astype(np.int16) - want["image"].astype(np.int16))
            assert diff.max() <= 1
            diffs.append(diff.mean())
            branches.add(len(want["boxes"]) < len(raw["boxes"]) or
                         max(want["image"].shape[:2]) < 480)
    assert float(np.mean(diffs)) <= 0.15
    assert branches == {True, False}  # both the crop branch and the plain resize ran


def test_normalize_host_matches_jax_normalize():
    """``normalize_host=True`` gives the JAX preset's float32 output exactly."""
    raw = _train_split()[3]
    jpreset = jtransforms.DetrPreset()
    jpreset.rng = random.Random(7)
    want = jpreset({**raw, "image": raw["image"].copy()})
    got = transforms.DetrPreset()(raw, random.Random(7))
    np.testing.assert_array_equal(got["image"], want["image"])


def test_loader_samples_do_not_depend_on_reader_threads():
    """Each sample draws from its own generator of (seed, epoch, index): one
    reader thread or four give the same batches, a second epoch other ones,
    and an epoch set by hand (a resume) the same ones again."""
    dataset = _train_split(transforms.detr(normalize_host=False))
    dataset.ids = dataset.ids[:6]

    def epoch_batches(workers, epoch):
        loader = DataLoader(dataset, batch_size=2, shuffle=True, seed=5, num_workers=workers,
                            fixed_canvas=(1344, 1344), drop_last=True)
        loader.epoch = epoch
        return list(loader)

    one, four = epoch_batches(1, 0), epoch_batches(4, 0)
    assert len(one) == 3
    for a, b in zip(one, four):
        for k in a:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    other = epoch_batches(4, 1)
    assert any(not np.array_equal(a["images"], b["images"]) for a, b in zip(one, other))
    again = epoch_batches(2, 1)
    for a, b in zip(other, again):
        np.testing.assert_array_equal(a["images"], b["images"])


def test_device_prefetch_on_the_cpu_normalises_like_the_host():
    """A uint8 batch through ``device_prefetch`` on the CPU: the JAX host
    normalisation, zero on the padding; the other keys as they were; the
    order kept; stage times recorded."""
    from relation_detr_tpu_torch.utils.evaluation import StageTimes

    rng = np.random.RandomState(0)
    batches = []
    for i in range(3):
        images = rng.randint(0, 256, (2, 32, 48, 3)).astype(np.uint8)
        mask = np.zeros((2, 32, 48), bool)
        mask[1, 20:] = True
        images[mask] = 0
        batches.append({"images": images, "mask": mask, "gt_labels": np.full((2, 4), i),
                        "gt_boxes": rng.rand(2, 4, 4).astype(np.float32),
                        "gt_valid": np.ones((2, 4), bool), "image_ids": np.arange(2)})
    times = StageTimes("cpu")
    got = list(device_prefetch(iter(batches), "cpu", keys=BATCH_KEYS, times=times))
    assert len(got) == 3 and set(times.ms) >= {"wait", "pin", "upload"}
    for out, batch in zip(got, batches):
        assert set(out) == set(BATCH_KEYS)
        want = jtransforms.normalize({"image": batch["images"]})["image"]
        want[batch["mask"]] = 0.0
        np.testing.assert_array_equal(out["images"].numpy(), want)
        for k in BATCH_KEYS[1:]:
            np.testing.assert_array_equal(out[k].numpy(), batch[k])


def _adam_moments(opt_state):
    """(mu, nu) of the ScaleByAdamState inside a MultiSteps state."""
    for s in opt_state.inner_opt_state:
        if hasattr(s, "mu"):
            return s.mu, s.nu
    raise AssertionError("no adam state")


TOL_ACCUM = 1e-6  # relative


def test_accumulation_matches_optax_multisteps():
    """4 micro-steps at ``accumulate_steps=2`` through the port's
    ``accumulate`` against the JAX ``build_optimizer(accumulate_steps=2)``
    (``optax.MultiSteps``) from the same gradients, on the tiny model's
    weights with every tensor moved off its initial value: micro-steps 1-2
    small (the mean's norm below ``max_norm``: no clip), 3-4 large (the clip
    bites). After each update the parameters and Adam's moments agree at
    1e-6 relative (the moments' near-zero entries at 1e-6 of the leaf's max);
    between updates nothing moves. (optax's bias correction of the second
    moment is float32, 1.3e-5 off 1 - 0.999, so an update's size differs by
    ~6e-6 of itself: parameters left at 0 would not agree at 1e-6.)"""
    model = TINY.build_model(device="cpu", seed=2)
    rng = np.random.RandomState(9)
    with torch.no_grad():
        for v in model.state_dict().values():
            v.add_(torch.from_numpy(rng.randn(*v.shape).astype(np.float32)) * 0.02)
    params, stats, _ = convert_state_dict(dict(model.state_dict()))
    shapes = {k: v.shape for k, v in params.items()}
    frozen = {k for k in params if jpg.is_frozen(tuple(k.split("/")))}
    seqs = []
    for scale in (2e-5, 3e-5, 1e-2, 2e-2):
        seqs.append({k: np.zeros(s, np.float32) if k in frozen else
                     (rng.randn(*s) * scale).astype(np.float32) for k, s in shapes.items()})
    norms = [math.sqrt(sum(float(np.sum(((a[k] + b[k]) / 2) ** 2)) for k in a))
             for a, b in (seqs[:2], seqs[2:])]
    assert norms[0] < 0.1 < norms[1]

    schedule_t = tpg.warmup_multistep_schedule(2e-4, 50, warmup_steps=4)
    schedule_j = jpg.warmup_multistep_schedule(2e-4, 50, warmup_steps=4)
    tx = jpg.build_optimizer(schedule_j, accumulate_steps=2)
    jparams = unflatten(params)
    jstate = tx.init(jparams)

    @jax.jit
    def jax_step(grads, opt_state, params):
        updates, opt_state = tx.update(grads, opt_state, params)
        return optax.apply_updates(params, updates), opt_state

    optimizer = tpg.build_optimizer(model, schedule_t, accumulate_steps=2)
    named = [(n, p) for n, p in model.named_parameters() if p.requires_grad]
    trainable = [p for _, p in named]
    accumulator = [torch.zeros_like(p) for p in trainable]
    state = TrainState()
    for i, grads in enumerate(seqs):
        jparams, jstate = jax_step(unflatten(grads), jstate, jparams)
        tgrads = state_dict_from_jax(grads, {})
        before = {n: p.detach().clone() for n, p in named}
        for n, p in named:
            p.grad = tgrads[n].clone()
        accumulate(optimizer, trainable, accumulator, state)
        assert all(p.grad is None for p in trainable)
        assert state.micro_steps == (i + 1) % 2 and state.updates == (i + 1) // 2
        if i % 2 == 0:
            assert all(torch.equal(p.detach(), before[n]) for n, p in named)
            continue
        want = state_dict_from_jax(flatten(jparams), stats)
        mu, nu = (state_dict_from_jax(flatten(m), {}) for m in _adam_moments(jstate))
        for n, p in named:
            for got, ref in ((p.detach(), want[n]), (optimizer.state[p]["exp_avg"], mu[n]),
                             (optimizer.state[p]["exp_avg_sq"], nu[n])):
                ref = ref.numpy()
                np.testing.assert_allclose(got.numpy(), ref, rtol=TOL_ACCUM,
                                           atol=TOL_ACCUM * float(np.abs(ref).max()), err_msg=n)
        assert all(float(a.abs().max()) == 0.0 for a in accumulator)


def test_nonfinite_micro_step_moves_nothing():
    """At ``accumulate_steps=2``: a NaN micro-step between two finite ones
    leaves the parameters, the accumulator and the micro-step count as they
    were and counts one skip; the next finite micro-step makes the update."""
    model = TINY.build_model(device="cpu", seed=3).train()
    optimizer = tpg.build_optimizer(model, 1e-4, accumulate_steps=2)
    step = make_train_step(model, TINY.build_criterion(), optimizer, TINY.hybrid_assign, seed=4)
    step(_small_batch(0))
    assert step.state.micro_steps == 1 and step.state.updates == 0
    params = {k: v.clone() for k, v in model.state_dict().items()}
    acc = {k: v.clone() for k, v in step.state_dict()["accumulator"].items()}
    assert any(float(v.abs().max()) > 0 for v in acc.values())
    bad = step(_small_batch(1, nan=True))
    assert not math.isfinite(bad["total_loss"]) and bad["nonfinite_count"] == 1
    assert step.state.micro_steps == 1 and step.state.updates == 0 and step.state.step == 2
    for k, v in model.state_dict().items():
        assert torch.equal(v, params[k]), k
    for k, v in step.state_dict()["accumulator"].items():
        assert torch.equal(v, acc[k]), k
    good = step(_small_batch(2))
    assert math.isfinite(good["total_loss"]) and good["nonfinite_count"] == 1
    assert step.state.micro_steps == 0 and step.state.updates == 1
    assert any(not torch.equal(v, params[k]) for k, v in model.state_dict().items())


@pytest.mark.parametrize("decay", [0.9, 0.999, 0.9998])
def test_ema_matches_jax_exactly(decay):
    """Three updates of an EMA of the tiny model's parameters (every 8th
    tensor), bit for bit against the JAX ``ema_update`` (eager; under
    ``jax.jit`` XLA fuses each product and sum into one FMA, an ulp away)
    on the same arrays."""
    rng = np.random.RandomState(1)
    model = TINY.build_model(device="cpu", seed=4)
    named = dict(list(model.named_parameters())[::8])
    params = {n: p.detach().numpy().copy() for n, p in named.items()}
    ema = ema_init(named)
    jema = {n: jnp.asarray(v) for n, v in params.items()}
    for _ in range(3):
        new = {n: (v + rng.randn(*v.shape) * 0.01).astype(np.float32) for n, v in params.items()}
        ema_update(ema, {n: torch.from_numpy(v) for n, v in new.items()}, decay)
        jema = jema_update(jema, {n: jnp.asarray(v) for n, v in new.items()}, decay)
    assert all(not torch.equal(ema[n], p.detach()) for n, p in named.items())
    for n, v in jema.items():
        np.testing.assert_array_equal(ema[n].numpy(), np.asarray(v), err_msg=n)


def test_save_weights_is_the_jax_layout(tmp_path):
    """``save_weights`` of the tiny model (perturbed, with class names)
    read by the JAX ``load_weights`` (strict: nothing missing or
    mismatched): every leaf equals ``convert_state_dict`` of the port's
    state_dict; the port's ``load_weights`` reads it back bit-identically and
    ``load_class_names`` the names."""
    model = TINY.build_model(device="cpu", seed=6)
    rng = np.random.RandomState(2)
    with torch.no_grad():
        for v in model.state_dict().values():
            v.add_(torch.from_numpy(rng.randn(*v.shape).astype(np.float32)) * 0.01)
    names = ("cat a", "dog", "c")
    path = str(tmp_path / "w.npz")
    save_weights(path, model, {"_classes_": encode_labels(names)})
    params, stats, leftover = convert_state_dict(dict(model.state_dict()))
    assert not leftover
    jmodel = JRelationDETR(**TINY.model_args)
    key = jax.random.key(0)
    variables = jax.eval_shape(lambda: jmodel.init(
        {"params": key, "denoising": key}, np.zeros((1, 128, 128, 3), np.float32),
        np.zeros((1, 128, 128), bool), np.zeros((1, 2), np.int32),
        np.full((1, 2, 4), 0.5, np.float32), np.ones((1, 2), bool), train=True))
    template = {k: jax.tree.map(lambda s: np.zeros(s.shape, s.dtype), v)
                for k, v in variables.items()}
    loaded = jax_load_weights(path, template, strict=True)
    got = {**{f"params/{k}": v for k, v in flatten(loaded["params"]).items()},
           **{f"batch_stats/{k}": v for k, v in flatten(loaded["batch_stats"]).items()}}
    want = {**{f"params/{k}": v for k, v in params.items()},
            **{f"batch_stats/{k}": v for k, v in stats.items()}}
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        np.testing.assert_array_equal(got[k], np.asarray(v), err_msg=k)
    fresh = TINY.build_model(device="cpu", seed=7)
    report = load_weights(fresh, path, strict=True)
    assert not report["missing"] and not report["mismatched"]
    for k, v in model.state_dict().items():
        assert torch.equal(fresh.state_dict()[k], v), k
    assert load_class_names(path) == names and decode_labels(encode_labels(names)) == names
    np.testing.assert_array_equal(encode_labels(names), jencode(names))


def test_checkpoint_manager_keeps_five_and_round_trips(tmp_path):
    """Epochs 0-6 saved: 2-6 kept; ``update_best`` reports what improved and
    the best metrics ride in the file; ``restore`` (``weights_only``) gives
    back the tensors, AdamW's state_dict and the plain values."""
    model = TINY.build_model(device="cpu", seed=8)
    optimizer = tpg.build_optimizer(model, 1e-4)
    for p in model.parameters():
        if p.requires_grad:
            p.grad = torch.ones_like(p)
    optimizer.step()
    manager = CheckpointManager(str(tmp_path / "checkpoints"))
    assert manager.latest_epoch() is None
    with pytest.raises(FileNotFoundError):
        manager.restore()
    assert manager.update_best(0.2, 0.5) == {"ap": True, "ap50": True}
    assert manager.update_best(0.3, 0.4) == {"ap": True, "ap50": False}
    acc = {"w": torch.arange(6.0).reshape(2, 3)}
    for epoch in range(7):
        manager.save(epoch, {"model": model.state_dict(), "optimizer": optimizer.state_dict(),
                             "train_step": {"state": {"step": epoch, "updates": 3},
                                            "accumulator": acc},
                             "ema": None, "epoch": epoch, "loader_epoch": epoch + 1})
    assert manager.epochs() == [2, 3, 4, 5, 6] and manager.latest_epoch() == 6
    other = CheckpointManager(str(tmp_path / "checkpoints"))
    saved = other.restore()
    assert other.best == {"ap": 0.3, "ap50": 0.5}
    assert saved["epoch"] == 6 and saved["loader_epoch"] == 7 and saved["ema"] is None
    assert saved["train_step"]["state"] == {"step": 6, "updates": 3}
    assert torch.equal(saved["train_step"]["accumulator"]["w"], acc["w"])
    for k, v in model.state_dict().items():
        assert torch.equal(saved["model"][k], v), k
    fresh = tpg.build_optimizer(TINY.build_model(device="cpu", seed=9), 1e-4)
    fresh.load_state_dict(saved["optimizer"])
    for (_, a), (_, b) in zip(sorted(fresh.state_dict()["state"].items()),
                              sorted(optimizer.state_dict()["state"].items())):
        for k in a:
            assert torch.equal(a[k], b[k]), k
    assert other.restore(epoch=3)["epoch"] == 3
