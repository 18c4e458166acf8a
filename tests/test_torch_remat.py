"""The port's rematerialisation policies (``models/transformer.py::
resolve_remat_policy``) on the CPU, under the bf16 policy.

Each policy recomputes the encoder and decoder layers in the backward
(``torch.utils.checkpoint``, non-reentrant) or, for ``save_all``, nothing;
none may change a number: the tiny-test config's train loss and every
gradient equal the unset policy's bit for bit, under torch's deterministic
algorithms (the plain MSDA backward's ``index_put_`` otherwise adds in a
varying order). Which products the backward runs again is counted with a
``TorchDispatchMode``: under "dots" none (the layers' ``mm`` / ``addmm`` /
``bmm`` outputs are saved), under "dots_no_batch" the ``bmm`` ones only,
under "none" all of them.
"""
import importlib

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from relation_detr_tpu_torch.losses.criterion import relation_detr_loss
from relation_detr_tpu_torch.models.transformer import resolve_remat_policy

TINY = importlib.import_module(
    "relation_detr_tpu_torch.configs.relation_detr.relation_detr_resnet50_tiny_test")
PRODUCTS = ("mm", "addmm", "bmm")


class ProductCount(TorchDispatchMode):
    """Counts the ``mm`` / ``addmm`` / ``bmm`` calls dispatched while on."""

    def __init__(self):
        super().__init__()
        self.counts = dict.fromkeys(PRODUCTS, 0)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        name = func.overloadpacket.__name__
        if name in self.counts:
            self.counts[name] += 1
        return func(*args, **(kwargs or {}))


def _step(policy):
    """One bf16 train forward + backward of the tiny config under
    ``policy``: (loss, {name: grad}, the backward's product counts)."""
    rng = np.random.RandomState(5)
    images = torch.from_numpy(rng.randn(2, 128, 160, 3).astype(np.float32))
    mask = torch.zeros(2, 128, 160, dtype=torch.bool)
    mask[1, 96:] = True
    labels = torch.tensor([[1, 2, -1], [0, -1, -1]])
    boxes = torch.tensor([[[0.5, 0.5, 0.2, 0.2], [0.3, 0.3, 0.1, 0.2], [0, 0, 0, 0]],
                          [[0.4, 0.6, 0.3, 0.3], [0, 0, 0, 0], [0, 0, 0, 0]]])
    valid = labels >= 0
    model = TINY.build_model("cpu", 0, "bfloat16", "bfloat16", policy).train()
    outputs = model(images, mask, labels, boxes, valid, train=True,
                    generator=torch.Generator().manual_seed(3))
    total, _ = relation_detr_loss(TINY.build_criterion(), outputs, labels, boxes, valid,
                                  TINY.hybrid_assign)
    counter = ProductCount()
    with counter:
        total.backward()
    grads = {n: p.grad for n, p in model.named_parameters() if p.grad is not None}
    return total.detach(), grads, counter.counts


@pytest.fixture(scope="module")
def deterministic():
    saved, threads = torch.are_deterministic_algorithms_enabled(), torch.get_num_threads()
    torch.use_deterministic_algorithms(True)
    torch.set_num_threads(1)
    yield
    torch.use_deterministic_algorithms(saved)
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def unset(deterministic):
    return _step(None)


@pytest.mark.parametrize("policy", ["none", "dots", "dots_no_batch", "save_all"])
def test_policy_is_bit_identical_to_no_recompute(policy, unset):
    """The loss and every gradient equal the unset policy's bit for bit."""
    loss, grads, _ = _step(policy)
    want_loss, want_grads, _ = unset
    assert torch.equal(loss, want_loss)
    assert sorted(grads) == sorted(want_grads) and len(grads) > 100
    for name, g in want_grads.items():
        assert torch.equal(grads[name], g), name


def test_products_run_again_in_the_backward(unset):
    """The backward's product calls beyond the unset policy's: none under
    "dots" and "save_all"; under "dots_no_batch" only ``bmm`` (the MHA's
    batched products); under "none" the layers' linears (``addmm``) and
    the MHA's ``bmm`` again."""
    base = unset[2]
    extra = {p: {k: n - base[k] for k, n in _step(p)[2].items()}
             for p in ("none", "dots", "dots_no_batch", "save_all")}
    assert extra["dots"] == extra["save_all"] == dict.fromkeys(PRODUCTS, 0)
    assert extra["dots_no_batch"]["bmm"] > 0
    assert extra["dots_no_batch"]["mm"] == extra["dots_no_batch"]["addmm"] == 0
    assert extra["none"]["addmm"] > 0 and extra["none"]["bmm"] == extra["dots_no_batch"]["bmm"]


def test_unknown_policy_raises_and_eval_recomputes_nothing():
    """An unknown name raises; without gradients a policy calls the layer
    as it is (no checkpoint)."""
    with pytest.raises(ValueError, match="unknown remat policy"):
        resolve_remat_policy("dots_saveable")
    run = resolve_remat_policy("dots")
    layer = torch.nn.Linear(4, 4)
    with torch.no_grad():
        out = run(layer, torch.ones(2, 4))
    assert out.grad_fn is None
    torch.testing.assert_close(out, layer(torch.ones(2, 4)).detach())
