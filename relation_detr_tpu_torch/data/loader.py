"""Batching into static canvases, with a threaded prefetch.

The port's copy of ``relation_detr_tpu/data/loader.py``:
``DEFAULT_BUCKETS``, ``MAX_GT`` and ``GT_BUCKETS``, ``aspect_ratio_group_ids``,
``pick_canvas``, ``collate``, ``DataLoader`` and ``device_prefetch``. Every
batch is padded to a canvas from a small bucket set and its ground truth to
a fixed capacity with a validity mask; one thread builds batches ahead of
the consumer while ``num_workers`` threads read (decode, transform) the
samples in order, a few ahead, across batch boundaries. The batch order
(seeded shuffle, aspect grouping, ``drop_last``, the process-stride shards
and the tail padding with ``image_id = -1``) is the JAX loader's, held equal
by ``tests/test_torch_data.py``.

Differences: a dataset with a ``read(index, rng)`` method (``CocoDetection``)
gets for each sample its own ``random.Random``, seeded from the loader's
seed, the epoch and the dataset index only (``sample_rng``), so its
augmentations do not depend on how the reader threads interleave, and a run
and its resume draw the same ones; the JAX preset shares one generator
across the threads. The process index and count default to an initialised
``torch.distributed``'s rank and world size (else 0 and 1); ``collate``'s
oversize branch resizes with ``data/transforms.py::resize_bilinear`` (no
antialias; within one level of cv2's INTER_LINEAR on uint8).
``device_prefetch`` takes a device instead of a JAX mesh (one process, one
device: under a process group, the process's own card), copies from pinned
buffers it reuses on a side stream, and normalises uint8 canvases on the
device. So under N processes with a per-process batch b, step i of rank r
takes per-process batch i * N + r of the one seeded batch list, and the
ranks' step-i batches together are the JAX loader's global batch i of N * b
images (the ``drop_last`` batch list of N * b when N divides its count of
b-image batches; otherwise this loader repeats batches from the start, as
under several JAX hosts).
"""
from __future__ import annotations

import collections
import queue
import random
import threading
from concurrent.futures import ThreadPoolExecutor
from contextlib import nullcontext
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch

from relation_detr_tpu_torch.data.transforms import IMAGENET_MEAN, IMAGENET_STD, resize_bilinear
from relation_detr_tpu_torch.parallel import mesh


# canvas buckets (h, w), /32-divisible, covering the detr preset's output
# range at max_size 1333; a batch picks the smallest canvas that fits.
DEFAULT_BUCKETS = ((512, 704), (608, 864), (736, 1024), (800, 1184), (800, 1344), (1344, 800), (1024, 736), (1344, 1344))
MAX_GT = 100  # COCO max instances/image is 93

# GT-capacity buckets: the batch's targets pad to the smallest bucket that
# fits its max instance count instead of always MAX_GT; the matcher and the
# hybrid branch pay per padded row, and ~92% of COCO images carry <= 16
# boxes.
GT_BUCKETS = (16, MAX_GT)


def aspect_ratio_group_ids(dataset, k: int = 3) -> np.ndarray:
    """Quantize image aspect ratios into 2k+1 log-spaced groups.

    As the reference's group_by_aspect_ratio.py:183-192, from the COCO
    metadata (widths/heights from the annotation index, no image decode).
    """
    bins = (2.0 ** np.linspace(-1, 1, 2 * k + 1)).tolist() if k > 0 else [1.0]
    ratios = []
    for img_id in dataset.ids:
        info = dataset.images[img_id]
        ratios.append(info["width"] / info["height"])
    return np.digitize(ratios, bins)


def pick_canvas(h: int, w: int, buckets: Sequence[Tuple[int, int]]) -> Tuple[int, int]:
    fits = [c for c in buckets if c[0] >= h and c[1] >= w]
    if fits:
        return min(fits, key=lambda c: c[0] * c[1])
    return max(buckets, key=lambda c: c[0] * c[1])


def collate(
    samples: List[Dict],
    buckets: Sequence[Tuple[int, int]] = DEFAULT_BUCKETS,
    max_gt: int = MAX_GT,
    fixed_canvas: Optional[Tuple[int, int]] = None,
    gt_buckets: Optional[Sequence[int]] = GT_BUCKETS,
) -> Dict[str, np.ndarray]:
    """Pad a list of transformed samples into one static-canvas batch.

    Boxes arrive as absolute xyxy on the (resized) image and leave as
    normalized cxcywh on the *canvas* — normalizing by the padded canvas and
    masking padding reproduces the reference's prepare_targets semantics
    (base_detector.py:177-188, which normalizes by the padded batch size).
    """
    bs = len(samples)
    max_h = max(s["image"].shape[0] for s in samples)
    max_w = max(s["image"].shape[1] for s in samples)
    if fixed_canvas is not None:
        canvas_h, canvas_w = fixed_canvas
    else:
        canvas_h, canvas_w = pick_canvas(max_h, max_w, buckets)

    # GT capacity = smallest bucket that fits the batch (see GT_BUCKETS)
    if gt_buckets:
        need = max((len(s["boxes"]) for s in samples), default=0)
        fits = [b for b in gt_buckets if need <= b <= max_gt]
        max_gt = min(fits) if fits else max_gt

    # canvas dtype follows the samples: uint8 when the transform defers
    # normalization to the device (EvalPreset(normalize_host=False))
    img_dtype = samples[0]["image"].dtype
    images = np.zeros((bs, canvas_h, canvas_w, 3), img_dtype)
    mask = np.ones((bs, canvas_h, canvas_w), bool)
    gt_boxes = np.zeros((bs, max_gt, 4), np.float32)
    gt_labels = np.full((bs, max_gt), -1, np.int32)
    gt_valid = np.zeros((bs, max_gt), bool)
    image_sizes = np.zeros((bs, 2), np.int64)
    orig_sizes = np.zeros((bs, 2), np.int64)
    image_ids = np.zeros((bs,), np.int64)

    for i, s in enumerate(samples):
        h, w = s["image"].shape[:2]
        if h > canvas_h or w > canvas_w:  # safety: downscale into canvas
            # bilinear without antialias, as cv2.resize's INTER_LINEAR
            # (within 1 level on uint8)
            r = min(canvas_h / h, canvas_w / w)
            new_h, new_w = int(h * r), int(w * r)
            s = dict(s)
            s["boxes"] = s["boxes"] * r
            s["image"] = resize_bilinear(s["image"], new_h, new_w, antialias=False)
            h, w = new_h, new_w
        images[i, :h, :w] = s["image"]
        mask[i, :h, :w] = False
        n = min(len(s["boxes"]), max_gt)
        if n:
            xyxy = s["boxes"][:n]
            cxcywh = np.stack(
                [
                    (xyxy[:, 0] + xyxy[:, 2]) / 2,
                    (xyxy[:, 1] + xyxy[:, 3]) / 2,
                    xyxy[:, 2] - xyxy[:, 0],
                    xyxy[:, 3] - xyxy[:, 1],
                ],
                -1,
            )
            # normalize by the *image* size (reference normalizes by the
            # per-image size recorded in ImageList.image_sizes)
            cxcywh = cxcywh / np.asarray([w, h, w, h], np.float32)
            gt_boxes[i, :n] = cxcywh
            gt_labels[i, :n] = s["labels"][:n]
            gt_valid[i, :n] = True
        image_sizes[i] = (h, w)
        orig_sizes[i] = s["orig_size"]
        image_ids[i] = s["image_id"]

    return {
        "images": images,
        "mask": mask,
        "gt_boxes": gt_boxes,
        "gt_labels": gt_labels,
        "gt_valid": gt_valid,
        "image_sizes": image_sizes,
        "orig_sizes": orig_sizes,
        "image_ids": image_ids,
    }


def sample_rng(seed: int, epoch: int, index: int) -> random.Random:
    """The generator of dataset sample ``index`` in ``epoch``: a function of
    (seed, epoch, index) only (a string seed is hashed with SHA-512, the
    same in every process)."""
    return random.Random(f"{seed}:{epoch}:{index}")


class DataLoader:
    """Multi-threaded map + prefetch loader over an indexable dataset.

    ``epoch`` numbers the next pass (its shuffle and its samples'
    generators) and counts up after each; a resumed run sets it."""

    def __init__(
        self,
        dataset,
        batch_size: int,
        shuffle: bool = False,
        seed: int = 0,
        num_workers: int = 4,
        buckets: Sequence[Tuple[int, int]] = DEFAULT_BUCKETS,
        max_gt: int = MAX_GT,
        fixed_canvas: Optional[Tuple[int, int]] = None,
        drop_last: bool = False,
        prefetch: int = 2,
        aspect_ratio_group_factor: int = -1,
        process_index: Optional[int] = None,
        process_count: Optional[int] = None,
        gt_buckets: Optional[Sequence[int]] = GT_BUCKETS,
    ):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.seed = seed
        self.num_workers = max(num_workers, 1)
        self.buckets = buckets
        self.max_gt = max_gt
        self.gt_buckets = tuple(gt_buckets) if gt_buckets else None
        self.fixed_canvas = fixed_canvas
        self.drop_last = drop_last
        self.prefetch = prefetch
        self.epoch = 0
        self.group_ids = None
        if aspect_ratio_group_factor >= 0 and hasattr(dataset, "images"):
            self.group_ids = aspect_ratio_group_ids(dataset, aspect_ratio_group_factor)
        # multi-process sharding (the reference's DistributedSampler role,
        # its util/utils.py:79-119): every process builds the SAME global
        # batch list (seeded shuffle) and takes a disjoint stride slice.
        # Defaults come from an initialised torch.distributed, else (0, 1).
        if process_index is None or process_count is None:
            process_index, process_count = mesh.world()
        if not 0 <= process_index < process_count:
            raise ValueError(f"process_index {process_index} not in [0, {process_count})")
        self.process_index = int(process_index)
        self.process_count = int(process_count)

    def __len__(self):
        n = len(self.dataset)
        if self.drop_last:
            total = n // self.batch_size
        else:
            total = (n + self.batch_size - 1) // self.batch_size
        if self.process_count > 1:
            # wraparound-padded to a multiple of process_count (_batches)
            return -(-total // self.process_count)
        return total

    def _batches(self) -> List[List[int]]:
        indices = np.arange(len(self.dataset))
        if self.shuffle:
            np.random.RandomState(self.seed + self.epoch).shuffle(indices)
        if self.group_ids is not None:
            # same-aspect-group batches (GroupedBatchSampler semantics,
            # group_by_aspect_ratio.py:14-76): batch within each group,
            # back-fill the cross-group remainder at the end.
            out, leftovers = [], []
            for g in np.unique(self.group_ids):
                members = indices[self.group_ids[indices] == g]
                full = len(members) // self.batch_size * self.batch_size
                out.extend(
                    members[i : i + self.batch_size].tolist()
                    for i in range(0, full, self.batch_size)
                )
                leftovers.extend(members[full:].tolist())
            out.extend(
                leftovers[i : i + self.batch_size]
                for i in range(0, len(leftovers), self.batch_size)
            )
            if self.shuffle:
                np.random.RandomState(self.seed * 31 + self.epoch).shuffle(out)
        else:
            out = [
                indices[i : i + self.batch_size].tolist()
                for i in range(0, len(indices), self.batch_size)
            ]
        if self.drop_last and out and len(out[-1]) < self.batch_size:
            out.pop()
        if self.process_count > 1:
            # pad the GLOBAL list to a multiple of process_count by wrapping
            # (DistributedSampler semantics: every host runs the same number
            # of steps so collectives stay aligned; the evaluator dedups the
            # repeated images by image_id), then take this host's stride.
            if out:
                n, i = len(out), 0
                while len(out) % self.process_count:
                    out.append(out[i % n])
                    i += 1
            out = out[self.process_index :: self.process_count]
        return out

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        batches = self._batches()
        q: queue.Queue = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()

        def safe_put(item) -> bool:
            """Put with stop polling so an abandoned iterator can't wedge the
            worker in a blocking put (which aborts at interpreter teardown)."""
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            return False

        epoch = self.epoch
        read = getattr(self.dataset, "read", None)

        def read_sample(index):
            if read is None:
                return self.dataset[index]
            return read(index, sample_rng(self.seed, epoch, index))

        def produce(pool, reads) -> None:
            # samples are read (decoded, transformed) in num_workers threads,
            # in order, up to `lookahead` ahead of the batch being collated,
            # so the threads also work across batch boundaries
            order = iter([i for batch_indices in batches for i in batch_indices])
            lookahead = 2 * max(self.num_workers, self.batch_size)

            def next_sample():
                for index in order:
                    reads.append(pool.submit(read_sample, index))
                    if len(reads) >= lookahead:
                        break
                return reads.popleft().result()

            for batch_indices in batches:
                if stop.is_set():
                    return
                samples = [next_sample() for _ in batch_indices]
                # pad ragged final batch by repeating the first sample
                while len(samples) < self.batch_size and not self.drop_last:
                    pad = dict(samples[0])
                    pad["boxes"] = pad["boxes"][:0]
                    pad["labels"] = pad["labels"][:0]
                    pad["image_id"] = -1
                    samples.append(pad)
                if not safe_put(collate(samples, self.buckets, self.max_gt,
                                        self.fixed_canvas, self.gt_buckets)):
                    return
            safe_put(None)

        def worker():
            reads = collections.deque()
            try:
                with ThreadPoolExecutor(self.num_workers) as pool:
                    try:
                        produce(pool, reads)
                    finally:
                        for future in reads:  # abandoned or failed: drop what is queued
                            future.cancel()
            except BaseException as e:  # surface loader errors to the consumer
                safe_put(e)

        thread = threading.Thread(target=worker, daemon=True)
        thread.start()
        try:
            while True:
                item = q.get()
                if item is None:
                    break
                if isinstance(item, BaseException):
                    raise item
                yield item
        finally:
            stop.set()
            # drain so the worker can't be blocked in a put, then join
            try:
                while True:
                    q.get_nowait()
            except queue.Empty:
                pass
            thread.join(timeout=5.0)
        self.epoch += 1


class Normalizer:
    """``(x / 255 - mean) / std`` of a uint8 (B, H, W, 3) canvas in float32
    on ``device``, its padding (``mask`` True) an exact 0: the host's
    ``transforms.normalize`` followed by ``collate``'s zero padding. 255 is
    a tensor: a Python scalar divisor makes the card multiply by its
    reciprocal, which rounds differently from the host's division."""

    def __init__(self, device):
        self.scale = torch.full((1,), 255.0, device=device)
        self.mean = torch.as_tensor(IMAGENET_MEAN, device=device)
        self.std = torch.as_tensor(IMAGENET_STD, device=device)

    def __call__(self, images: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        x = (images.to(torch.float32) / self.scale - self.mean) / self.std
        return torch.where(mask[..., None], 0.0, x)


def device_prefetch(iterator, device, keys: Sequence[str] = None, depth: int = 2,
                    times=None):
    """Yields ``iterator``'s batches with ``keys`` (every key when None) as
    tensors on ``device``, ``depth`` batches ahead of the consumer (the
    reference's DataPrefetcher, its util/collate_fn.py:17-49).

    On a card each batch is copied into pinned host buffers, reused from
    batch to batch (``depth`` + 1 sets per shape, a set written again only
    once its copies are done), then to the card on a side stream, where a
    uint8 ``images`` canvas is also normalised (``Normalizer``); the
    consumer's stream waits for that work before it uses the tensors. So
    batch k+1's upload runs while step k computes. On the CPU the arrays
    are wrapped as they are, and a uint8 canvas is normalised there.

    ``times`` (optional, a ``utils.evaluation.StageTimes``) gathers
    "wait" (host clock in the iterator: the consumer waiting for the
    loader), "pin" (host clock, the copy into pinned memory) and "upload"
    (the side stream's span of the copies and the normalisation)."""
    device = torch.device(device)
    cuda = device.type == "cuda"
    normalize = Normalizer(device)
    stream = torch.cuda.Stream(device) if cuda else None
    pinned = collections.defaultdict(collections.deque)  # (key, shape, dtype) -> buffers
    span = (lambda name, on_card=True: times.span(name, on_card)) if times is not None \
        else (lambda name, on_card=True: nullcontext())
    queue_ = collections.deque()

    def host_tensor(key, array):
        """(ring key, host tensor holding ``array``)."""
        ring_key = (key, array.shape, array.dtype.str)
        if not cuda:
            return ring_key, torch.from_numpy(array)
        ring = pinned[ring_key]
        if len(ring) > depth:  # the oldest buffer's copy was queued depth+1 batches ago
            buf, done = ring.popleft()
            done.synchronize()
        else:
            buf = torch.empty(array.shape, dtype=torch.from_numpy(array[:0]).dtype,
                              pin_memory=True)
        buf.numpy()[...] = array
        return ring_key, buf

    def put(batch):
        names = keys if keys is not None else list(batch)
        with span("pin", on_card=False):
            host = {k: host_tensor(k, np.ascontiguousarray(batch[k])) for k in names}
        done = None
        with torch.cuda.stream(stream) if cuda else nullcontext():
            with span("upload"):
                out = {k: t.to(device, non_blocking=True) for k, (_, t) in host.items()}
                if "images" in out and out["images"].dtype == torch.uint8:
                    out["images"] = normalize(out["images"], out["mask"])
            if cuda:
                done = torch.cuda.Event()
                done.record(stream)
                for ring_key, t in host.values():
                    pinned[ring_key].append((t, done))
        queue_.append((out, done))

    def pull():
        with span("wait", on_card=False):
            return next(it)

    it = iter(iterator)
    try:
        for _ in range(depth):
            put(pull())
    except StopIteration:
        pass
    while queue_:
        out, done = queue_.popleft()
        try:
            put(pull())
        except StopIteration:
            pass
        if done is not None:
            current = torch.cuda.current_stream(device)
            current.wait_event(done)
            for t in out.values():
                t.record_stream(current)  # allocated on the side stream
        yield out
