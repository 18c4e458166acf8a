"""Process groups for data parallelism: one process per card over
``torch.distributed``. Counterpart of ``relation_detr_tpu/parallel/mesh.py``
(``create_mesh`` and the batch sharding, ``:19-36``) and of the JAX
evaluation's process gather (``relation_detr_tpu/utils/evaluation.py:186-196``).

The JAX step is one program over a device mesh, and XLA inserts its
collectives. Here every process runs the step on its own slice of the
global batch and the collectives are explicit, all through this module:
``all_reduce`` (the gradients and metrics, the global ground-truth counts)
and ``all_gather_array`` (the evaluation's detections).

Backends: NCCL when the processes use cards, gloo on the CPU. Gloo with
tensors on a card is taken only when the caller names it (``backend=
"gloo"``): it is how two processes share one card, which NCCL refuses.
Nothing falls back from one backend to the other. With no process group,
or a group of one process, no collective runs and every function here
returns at once.

Launch under ``python -m torch.distributed.run --nproc-per-node N ...``
(``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK`` and the rendezvous address come
from its environment), or pass ``init_method``, ``rank`` and ``world_size``.
"""
from __future__ import annotations

import datetime
import os
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

DEFAULT_TIMEOUT_S = 600.0


def initialized() -> bool:
    return dist.is_available() and dist.is_initialized()


def world() -> Tuple[int, int]:
    """(rank, world size) of the default group, (0, 1) without one."""
    if initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def active() -> bool:
    """A group of more than one process: collectives run."""
    return world()[1] > 1


def is_main() -> bool:
    return world()[0] == 0


def backend_name() -> Optional[str]:
    return dist.get_backend() if initialized() else None


def init_distributed(backend: Optional[str] = None, device: str = "cuda",
                     init_method: Optional[str] = None, rank: Optional[int] = None,
                     world_size: Optional[int] = None, local_rank: Optional[int] = None,
                     timeout_s: float = DEFAULT_TIMEOUT_S) -> torch.device:
    """Joins the default process group and returns this process's device.

    ``rank``, ``world_size`` and ``local_rank`` default to torchrun's
    ``RANK``, ``WORLD_SIZE`` and ``LOCAL_RANK``; ``init_method`` to its
    environment rendezvous. ``device`` "cuda": the process takes card
    ``local_rank`` and the backend defaults to NCCL, which needs a card per
    process; ``backend="gloo"`` puts the processes on the cards round-robin
    (two on one card where there is one). ``device`` "cpu": gloo. A
    collective that waits longer than ``timeout_s`` fails."""
    rank = int(os.environ["RANK"]) if rank is None else rank
    world_size = int(os.environ["WORLD_SIZE"]) if world_size is None else world_size
    if local_rank is None:
        local_rank = int(os.environ.get("LOCAL_RANK", rank))
    cuda = torch.device(device).type == "cuda"
    backend = backend or ("nccl" if cuda else "gloo")
    if backend not in ("nccl", "gloo"):
        raise ValueError(f"backend {backend!r}: use nccl or gloo")
    if backend == "nccl" and not cuda:
        raise ValueError("the NCCL backend needs cards: --device cuda, or gloo on the CPU")
    kwargs = {}
    if cuda:
        count = torch.cuda.device_count()
        if count == 0:
            raise RuntimeError("no CUDA device: run on the CPU with --device cpu")
        if backend == "nccl" and local_rank >= count:
            raise RuntimeError(f"NCCL needs a card per process: local rank {local_rank} on a "
                               f"machine with {count} card(s); two processes can share a "
                               "card only under gloo (backend='gloo')")
        dev = torch.device("cuda", local_rank % count)
        torch.cuda.set_device(dev)
        if backend == "nccl":
            kwargs["device_id"] = dev
    else:
        dev = torch.device("cpu")
    dist.init_process_group(backend, init_method=init_method, rank=rank,
                            world_size=world_size,
                            timeout=datetime.timedelta(seconds=timeout_s), **kwargs)
    return dev


def join_from_env(device: str, backend: Optional[str] = None) -> Tuple[torch.device, bool]:
    """For a CLI: (this process's device, whether this call joined the
    group). A process launched by torch.distributed.run (its ``WORLD_SIZE``
    is set) joins the group (``init_distributed``) unless a caller has
    already joined one; any other runs alone on ``device``."""
    if initialized():
        if torch.device(device).type == "cuda":
            return torch.device("cuda", torch.cuda.current_device()), False
        return torch.device(device), False
    if "WORLD_SIZE" in os.environ:
        return init_distributed(backend, device), True
    return torch.device(device), False


def destroy() -> None:
    if initialized():
        dist.destroy_process_group()


def barrier() -> None:
    if active():
        dist.barrier()


def all_reduce(tensors: Sequence[torch.Tensor]) -> None:
    """Sums ``tensors`` (one dtype, one device) over the group in place, as
    one flat buffer: one collective whatever their number. (Gloo sums
    tensors on a card itself, through host memory.)"""
    if not active() or not tensors:
        return
    flat = torch.cat([t.reshape(-1) for t in tensors])
    dist.all_reduce(flat)
    offset = 0
    for t in tensors:
        t.copy_(flat[offset:offset + t.numel()].view_as(t))
        offset += t.numel()


def global_gt_counts(gt_valid: torch.Tensor) -> Optional[Tuple[torch.Tensor, torch.Tensor]]:
    """(valid ground-truth boxes summed over every process's batch, the most
    any one image of them holds), int64 tensors on ``gt_valid``'s device;
    None without a group of more than one process (the caller then counts
    its own batch). One sum all-reduce: each rank's maximum rides in its own
    slot."""
    if not active():
        return None
    rank, size = world()
    counts = torch.zeros(size + 1, dtype=torch.int64, device=gt_valid.device)
    per_image = gt_valid.sum(1)
    counts[0] = per_image.sum()
    counts[rank + 1] = per_image.max() if per_image.numel() else 0
    dist.all_reduce(counts)
    return counts[0], counts[1:].max()


def all_gather_array(array: np.ndarray) -> List[np.ndarray]:
    """Every process's ``array`` (same dtype and trailing shape, any leading
    length), in rank order: the lengths are gathered first, then each array
    padded to the longest (``relation_detr_tpu/utils/evaluation.py:186-196``).
    One process: ``[array]``."""
    if not active():
        return [array]
    _, size = world()
    # host data rides NCCL on the current card, gloo on the CPU
    dev = torch.device("cuda", torch.cuda.current_device()) if backend_name() == "nccl" \
        else torch.device("cpu")
    n = torch.tensor([array.shape[0]], dtype=torch.int64, device=dev)
    lengths = [torch.zeros_like(n) for _ in range(size)]
    dist.all_gather(lengths, n)
    lengths = [int(x.item()) for x in lengths]
    padded = np.zeros((max(max(lengths), 1), *array.shape[1:]), array.dtype)
    padded[: array.shape[0]] = array
    local = torch.from_numpy(padded).to(dev)
    out = [torch.empty_like(local) for _ in range(size)]
    dist.all_gather(out, local)
    return [t.cpu().numpy()[:k] for t, k in zip(out, lengths)]
