"""The port's tools and op binding on the CPU, at the tiny config:

- the ops of ``ops/library.py``: each fake implementation's shape and dtype
  against its plain version's output, and ``FlopCounterMode`` counting an
  MSDA call, the relation biases and the bilinear sampler by
  ``utils/flops.py``'s formulas;
- ``tools/export_model.py``: the tiny config exported, saved, read back from
  disk and run equal to the live model (rtol 1e-3 / atol 1e-5, labels
  equal), the hand kernels in the graph as ops, and a corrupted file
  failing; an export under impl="tiled" keeping the tile geometry's
  cached device constants real; ``tools/benchmark_model.py``'s parameters
  and FLOPs;
- the eval CLI's and the folder CLI's ``--show-dir`` against the JAX
  package's drawing and ``cv2.imencode``, byte for byte;
- ``tools/visualize_datasets.py``, ``tools/make_synth_coco_scale.py`` (n=3)
  and ``tools/convert_torch_weights.py`` against the root tools' files, and
  ``tools/mc_distribution.py``'s values and summary against the root tool's
  arithmetic.

cv2 decodes JPEGs (the CPU has no JPEG decoder). torch runs on one thread.
"""
import filecmp
import importlib.util
import json
import os
import shutil
import sys

import cv2
import numpy as np
import pytest
import torch

from relation_detr_tpu.data.coco import CocoDetection as JCocoDetection
from relation_detr_tpu.utils import visualize as jax_visualize
from relation_detr_tpu_torch import inference
from relation_detr_tpu_torch import test as port_test
from relation_detr_tpu_torch.ops import (  # noqa: F401
    grid_sample,
    library,
    msda,
    msda_tiled,
    relation_bias,
)
from relation_detr_tpu_torch.tools import (
    benchmark_model,
    convert_torch_weights,
    export_model,
    make_synth_coco_scale,
    mc_distribution,
    visualize_datasets,
)
from relation_detr_tpu_torch.utils import flops
from relation_detr_tpu_torch.utils.class_names import encode_labels, load_class_names
from relation_detr_tpu_torch.utils.config import Config
from relation_detr_tpu_torch.utils.weights import save_weights

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = os.path.join(REPO, "relation_detr_tpu_torch", "configs", "relation_detr",
                    "relation_detr_resnet50_tiny_test.py")
COCO = os.path.join(REPO, "tests", "data", "torch_port", "synth_coco")
CANVAS = (64, 96)  # levels (8, 12), (4, 6), (2, 3), (1, 2): 128 tokens, 60 queries


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def cv2_decode(data):
    return cv2.cvtColor(cv2.imdecode(data, cv2.IMREAD_COLOR), cv2.COLOR_BGR2RGB)


def _root_tool(name):
    spec = importlib.util.spec_from_file_location(f"root_{name}",
                                                  os.path.join(REPO, "tools", f"{name}.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _op_cases():
    """(op name, plain-version inputs) of each op, small and seeded."""
    g = torch.Generator().manual_seed(0)
    levels = ((5, 4), (2, 3))
    value = torch.randn(2, 26, 4, 8, generator=g)
    locs = torch.rand(2, 7, 4, 2, 3, 2, generator=g)
    attn = torch.rand(2, 7, 4, 2, 3, generator=g)
    boxes = torch.rand(2, 9, 4, generator=g) * 0.5 + 0.25
    kernel, bias = torch.randn(64, 8, generator=g), torch.randn(8, generator=g)
    m = torch.randint(-1, 20, (1, 3, 2, 16, 8), generator=g, dtype=torch.int32)
    oy, ox = torch.rand(1, 3, 2, 4, 5, 8, generator=g), torch.rand(1, 3, 2, 4, 6, 8, generator=g)
    return [
        ("msda_fwd", (value, library.flat_levels(levels), locs, attn)),
        ("msda_fwd", (value.bfloat16(), library.flat_levels(levels), locs, attn)),
        ("relation_bias_v4_fwd", (boxes, boxes[:, :5].contiguous(), kernel, bias, 16,
                                  10000.0, 100.0, 1e-5)),
        ("relation_bias_rel_fwd", (torch.randn(2, 9, 5, 4, generator=g), kernel, bias, 16,
                                   10000.0, 100.0)),
        ("tiled_core_fwd", (m, torch.rand(m.shape, generator=g),
                            torch.randn(1, 3, 20, 16, generator=g), 2, 8)),
        ("sep_contract_fwd", (oy, ox, torch.randn(1, 3, 30, 16, generator=g))),
        ("bilinear_sample_fwd", (torch.randn(2, 5, 7, 8, generator=g),
                                 torch.rand(2, 11, 2, generator=g) * 6 - 0.5)),
    ]


def test_op_fakes_match_plain_versions():
    """Each op's fake (run on meta tensors) gives its plain version's shape
    and dtype; the CPU tensors take the plain version and launch nothing."""
    launches = [msda.multi_scale_deformable_attention.launches,
                relation_bias.relation_bias_v4.launches]
    for name, args in _op_cases():
        op = getattr(library.OPS, name).default
        want = op(*args)
        meta = [a.to("meta") if isinstance(a, torch.Tensor) else a for a in args]
        got = op(*meta)
        assert (got.shape, got.dtype) == (want.shape, want.dtype), name
        assert torch.isfinite(want.float()).all(), name
    assert launches == [msda.multi_scale_deformable_attention.launches,
                        relation_bias.relation_bias_v4.launches]
    np.testing.assert_array_equal(  # the op is the wrapper's plain version, exactly
        library.OPS.msda_fwd(*_op_cases()[0][1]).numpy(),
        msda.msda_reference(_op_cases()[0][1][0], ((5, 4), (2, 3)),
                            *_op_cases()[0][1][2:]).numpy())


def test_flop_counter_counts_the_ops_by_their_formulas():
    """``FlopCounterMode`` on one MSDA call counts 10 B Q H D L P; over the
    tiny model's eval forward it counts each op's calls by their formulas
    (``benchmark_model``'s FLOPs), beside the matmuls and convolutions."""
    (name, args), = [c for c in _op_cases()[:1]]
    value, levels, locs, attn = args
    _, total, ops = flops.count_flops(msda.multi_scale_deformable_attention, value,
                                      library.levels(levels), locs, attn)
    assert total == ops["msda_fwd"] == 10 * 2 * 7 * 4 * 8 * 2 * 3
    for name, args in _op_cases()[2:]:
        _, total, ops = flops.count_flops(getattr(library.OPS, name), *args)
        assert total == ops[name] > 0, name
    result = benchmark_model.main(["--model-config", TINY, "--height", str(CANVAS[0]),
                                   "--width", str(CANVAS[1]), "--device", "cpu"])
    model = Config(TINY).build_model(device="cpu")
    assert result["params"] == sum(t.numel() for t in (*model.parameters(), *model.buffers()))
    tokens, queries = 96 + 24 + 6 + 2, 60
    assert result["op_flops"] == {
        "msda_fwd": 10 * (tokens + 2 * queries) * 256 * 4 * 4,
        "relation_bias_v4_fwd": queries * queries * (32 + 128 * 8)}
    assert result["flops"] > sum(result["op_flops"].values())
    assert "p50_ms" not in result  # no latency without a card


def test_export_round_trip_through_disk(tmp_path):
    """The tiny config's eval forward + ``post_process`` exported, written,
    read back from disk and run on ``RandomState(0)`` images: equal to the
    live port model at rtol 1e-3 / atol 1e-5, labels equal; the graph calls
    the ops (3 MSDA, 1 relation bias) and nothing of the tiled forms; a file
    sprayed with flipped bytes does not verify."""
    out = str(tmp_path / "tiny.pt2")
    result = export_model.main(["--model-config", TINY, "--output", out, "--height",
                                str(CANVAS[0]), "--width", str(CANVAS[1]), "--verify",
                                "--device", "cpu", "--graph-out", str(tmp_path / "g.txt")])
    assert set(result["verify"]) == {"scores", "boxes"}
    targets = [str(n.target) for n in result["program"].graph.nodes]
    assert targets.count("relation_detr.msda_fwd.default") == 3
    assert targets.count("relation_detr.relation_bias_v4_fwd.default") == 1
    assert "relation_detr.msda_fwd" in open(tmp_path / "g.txt").read()
    blob = bytearray(open(out, "rb").read())
    third = len(blob) // 3
    for i in range(third, 2 * third, 997):  # a spray across the middle third
        blob[i] ^= 0xFF
    bad = str(tmp_path / "bad.pt2")
    with open(bad, "wb") as f:
        f.write(bytes(blob))
    with pytest.raises(Exception):
        export_model.verify(export_model.load(bad), result["serving"], result["example"])


def test_export_under_tiled_keeps_the_device_constants_real():
    """Exported under impl="tiled" with no geometry cached yet, the model
    still runs eagerly after, and equal to the program: the tile
    geometry's device constants made while tracing are the trace's (fake)
    and stay out of ``msda_tiled``'s cache."""
    serving, example = export_model.build_serving_module(TINY, *CANVAS, device="cpu")
    msda_tiled._DEVICE_INDEX.clear()
    with msda.msda_defaults(impl="tiled"):
        program = export_model.export(serving, example)
        assert not msda_tiled._DEVICE_INDEX
        with torch.no_grad():
            want = serving(*example)
            got = program.module()(*example)
    assert all(not isinstance(t, torch._subclasses.FakeTensor)
               for entry in msda_tiled._DEVICE_INDEX.values() for t in entry[:3])
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_eval_cli_show_dir_matches_jax(tmp_path, monkeypatch):
    """``test.main(--show-dir --show-conf 0)`` on the committed split: each
    written file is ``cv2.imwrite`` of the JAX ``_render_prediction``'s
    drawing (``cv2.imread`` of the original, the split's category names)."""
    seen = []
    render = port_test.render_prediction

    def recording(dataset, image_id, det, *args):
        seen.append((dataset.images[image_id]["file_name"], det.copy()))
        return render(dataset, image_id, det, *args)

    monkeypatch.setattr(port_test, "render_prediction", recording)
    show = str(tmp_path / "show")
    run = port_test.main(["--coco-path", COCO, "--model-config", TINY, "--device", "cpu",
                          "--batch-size", "2", "--max-images", "2", "--show-dir", show,
                          "--show-conf", "0"], decode=cv2_decode)
    assert len(seen) == 2 and sorted(run["shown"]) == sorted(
        os.path.join(show, os.path.basename(f)) for f, _ in seen)
    with open(os.path.join(COCO, "annotations", "instances_val2017.json")) as f:
        cats = {c["id"]: c["name"] for c in json.load(f)["categories"]}
    names = [cats.get(i, str(i)) for i in range(max(cats) + 1)]
    for file_name, det in seen:
        image = cv2.imread(os.path.join(COCO, "val2017", file_name))
        keep = det[:, 4] >= 0
        want = jax_visualize.plot_bounding_boxes_on_image(
            image, det[keep, :4], det[keep, 4], det[keep, 5].astype(np.int64),
            class_names=names)
        written = open(os.path.join(show, os.path.basename(file_name)), "rb").read()
        assert written == cv2.imencode(".jpg", want)[1].tobytes(), file_name


def test_folder_cli_show_dir_matches_jax(tmp_path, monkeypatch):
    """``inference.main(--show-dir)`` over a JPEG with EXIF orientation,
    with a weight file that holds ``_classes_``: the drawing equals the JAX
    folder CLI's (``cv2.imread`` of the file, the checkpoint's class names),
    byte for byte as ``cv2.imwrite`` writes it. (A PNG goes through the same
    ``write_image``, ``test_torch_visualize.py``.) The CLI's canvas is cut
    to 320x320, which holds the tiny config's 299x224 resize."""
    monkeypatch.setattr(inference, "CANVAS", (320, 320))
    images = tmp_path / "images"
    images.mkdir()
    shutil.copy(os.path.join(REPO, "tests", "data", "torch_port", "decode_exif6.jpg"),
                images / "a.jpg")
    names = ("cat", "dog with a long name", "x")
    checkpoint = str(tmp_path / "tiny.npz")
    save_weights(checkpoint, Config(TINY).build_model(device="cpu"),
                 extra={"_classes_": encode_labels(names)})
    assert load_class_names(checkpoint) == names
    show = str(tmp_path / "show")
    result = inference.main(["--image-dir", str(images), "--model-config", TINY, "--device",
                             "cpu", "--checkpoint", checkpoint, "--score-threshold", "0",
                             "--show-dir", show], decode=cv2_decode)
    assert result["written"] == [os.path.join(show, "a.jpg")]
    det = result["detections"]["a.jpg"]
    assert len(det["scores"]) == 30
    want = jax_visualize.plot_bounding_boxes_on_image(
        cv2.imread(str(images / "a.jpg")), det["boxes"], det["scores"], det["labels"],
        class_names=names)
    assert open(result["written"][0], "rb").read() == cv2.imencode(".jpg", want)[1].tobytes()


def test_visualize_datasets_matches_the_root_tool(tmp_path, monkeypatch):
    """Both presets over 2 train samples: the files equal the root tool's."""
    root = _root_tool("visualize_datasets")
    for preset in ("detr", "none"):
        want, got = str(tmp_path / f"{preset}_root"), str(tmp_path / preset)
        monkeypatch.setattr(sys, "argv", ["x", "--coco-path", COCO, "--show-dir", want,
                                          "--num-images", "2", "--preset", preset])
        root.main()
        written = visualize_datasets.main(["--coco-path", COCO, "--show-dir", got,
                                           "--num-images", "2", "--preset", preset,
                                           "--device", "cpu"], decode=cv2_decode)
        assert len(written) == 2
        for path in written:
            assert filecmp.cmp(path, os.path.join(want, os.path.basename(path)), shallow=False)


def test_make_synth_coco_scale_matches_the_root_tool(tmp_path, monkeypatch):
    """n=3: the same JPEGs byte for byte and the same annotations file."""
    root = _root_tool("make_synth_coco_scale")
    args = ["--n-val", "3", "--height", "100", "--width", "120"]
    monkeypatch.setattr(sys, "argv", ["x", str(tmp_path / "root"), *args])
    root.main()
    make_synth_coco_scale.main([str(tmp_path / "port"), *args])
    compare = filecmp.dircmp(str(tmp_path / "root"), str(tmp_path / "port"))
    for sub in ("val2017", "annotations"):
        files = sorted(os.listdir(tmp_path / "root" / sub))
        assert files == sorted(os.listdir(tmp_path / "port" / sub))
        match, mismatch, errors = filecmp.cmpfiles(str(tmp_path / "root" / sub),
                                                   str(tmp_path / "port" / sub), files,
                                                   shallow=False)
        assert not mismatch and not errors and len(match) == len(files), (sub, compare)


def test_mc_distribution_matches_the_root_tool(tmp_path):
    """The per-image values and the summary line on the committed val split
    equal the root tool's arithmetic (its ``box_pair_relation`` over the JAX
    dataset's boxes: the root ``main`` unpacks two values from ``_prepare``,
    which returns three, so it cannot run); the histogram is a 720x480 PNG."""
    root = _root_tool("mc_distribution")
    ann = os.path.join(COCO, "annotations", "instances_val2017.json")
    jds = JCocoDetection(os.path.join(COCO, "val2017"), ann)
    want = []
    for img_id in jds.ids:
        info = jds.images[img_id]
        boxes = jds._prepare(img_id, info["height"], info["width"])[0]
        if len(boxes) < 2:
            continue
        cxcywh = np.stack([(boxes[:, 0] + boxes[:, 2]) / 2 / info["width"],
                           (boxes[:, 1] + boxes[:, 3]) / 2 / info["height"],
                           (boxes[:, 2] - boxes[:, 0]) / info["width"],
                           (boxes[:, 3] - boxes[:, 1]) / info["height"]], -1)
        rel = root.box_pair_relation(cxcywh)
        want.append(float(np.abs(rel[~np.eye(len(boxes), dtype=bool)]).mean()))
    want = np.asarray(want)
    out = str(tmp_path / "mc.png")
    got = mc_distribution.main(["--coco-path", COCO, "--output", out])
    np.testing.assert_array_equal(got, want)
    assert len(got) >= 2
    assert mc_distribution.summary(got) == (
        f"{len(want)} images with >=2 boxes; "
        f"MC mean {want.mean():.4f}  median {np.median(want):.4f}  "
        f"p10 {np.percentile(want, 10):.4f}  p90 {np.percentile(want, 90):.4f}")
    assert cv2.imread(out).shape == (480, 720, 3)


def test_convert_torch_weights_matches_the_root_tool(tmp_path, monkeypatch):
    """A reference-named state_dict (the tiny port model's) converted by both
    tools: the same arrays; the port's ``--model-config`` report loads every
    tensor of the model."""
    model = Config(TINY).build_model(device="cpu", seed=3)
    pth = str(tmp_path / "ref.pth")
    torch.save({"model": model.state_dict()}, pth)
    monkeypatch.setattr(sys, "argv", ["x", "--torch-checkpoint", pth, "--output",
                                      str(tmp_path / "root.npz")])
    _root_tool("convert_torch_weights").main()
    result = convert_torch_weights.main(["--torch-checkpoint", pth, "--output",
                                         str(tmp_path / "port.npz"), "--model-config", TINY,
                                         "--device", "cpu"])
    with np.load(tmp_path / "root.npz") as want, np.load(tmp_path / "port.npz") as got:
        assert sorted(want.files) == sorted(got.files)
        for key in want.files:
            np.testing.assert_array_equal(got[key], want[key], err_msg=key)
    report = result["report"]
    assert not report["missing"] and not report["mismatched"] and report["loaded"]
