"""The DCN sampler's kernels against another version of them, on one card.

    python -m relation_detr_tpu_torch.tools.sampler_ab --other DIR/grid_sample.cu \\
        [--iters 20] [--rounds 2] [--json OUT.json]

Run from the root of the repo (it takes the R50-DCN's sampler shapes and
inputs from ``chip_smoke.py``). ``--other`` is another version of
``csrc/grid_sample.cu`` with the same C interface, for example an earlier
commit's (``git show REV:relation_detr_tpu_torch/csrc/grid_sample.cu``),
whose backward leaves the zeroing of the map gradient to its caller, as the
first kernels did. It is built with the package's nvcc flags while the
package builds. At each ``chip_smoke.DCN_SAMPLERS`` shape and at the wide
layer2.0 case (``chip_smoke.sampler_wide_inputs``) both versions' forward
and backward are held against the plain versions (the output within
``TOL_KERNEL`` of its max, each gradient within ``TOL_SAMPLER_GRAD``, NaN
exactly where the plain version has it). Then each version's device ms a
launch is read from ``torch.profiler`` (every kernel and memset of a session
of ``--iters`` launches: the backward with its map gradient's zeroing, the
other version's by ``zero_()`` before each launch), in turns: other, this,
this, other, ``--rounds`` times, the mean of each. It prints the card's name
and power limit, a line a shape with both versions' times beside the bound,
and the sums over a forward's 13 DCNs; ``--json`` writes them too. The exit
code is 1 when either version disagrees with the plain versions.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys
import tempfile

import torch

from relation_detr_tpu_torch import _build
from relation_detr_tpu_torch.ops import grid_sample as gs

_P, _I = ctypes.c_void_p, ctypes.c_int64


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--other", required=True, help="another version of csrc/grid_sample.cu")
    p.add_argument("--iters", type=int, default=20, help="launches a profiler session")
    p.add_argument("--rounds", type=int, default=2, help="turns of other, this, this, other")
    p.add_argument("--json", default=None, help="write the rows here too")
    return p.parse_args(argv)


def build_other(path: str, out_dir: str):
    """Compile ``path`` into a library of its own (with the package's
    headers) while the package's kernels build; returns both loaded."""
    so = os.path.join(out_dir, "grid_sample_other.so")
    proc = subprocess.Popen([_build.find_nvcc(), *_build.NVCC_FLAGS, "-shared", "-I",
                             str(_build.CSRC), "-o", so, path],
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    this = _build.load_library()
    log = proc.communicate()[0]
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {path}:\n{log}")
    other = ctypes.CDLL(so)
    other.bilinear_sample_fwd.argtypes = [_P, _P, _P, _I, _I, _I, _I, _I, _P]
    other.bilinear_sample_bwd.argtypes = [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P]
    other.bilinear_sample_fwd.restype = other.bilinear_sample_bwd.restype = ctypes.c_int
    return this, other


def launchers(lib, zero_first, feat, points, grad_out):
    """(forward, backward): one launch each of ``lib``'s C entries into
    buffers made here; ``zero_first`` zeroes the map gradient before the
    backward."""
    b, h, w, c = feat.shape
    n = points.shape[1]
    out, grad_feat, grad_points = (torch.empty(b, n, c, device=feat.device),
                                   torch.empty_like(feat), torch.empty_like(points))

    def fwd():
        stream = torch.cuda.current_stream().cuda_stream
        code = lib.bilinear_sample_fwd(feat.data_ptr(), points.data_ptr(), out.data_ptr(), b, h,
                                       w, c, n, stream)
        if code != 0:
            raise RuntimeError(f"bilinear_sample_fwd returned {code}")
        return out

    def bwd():
        if zero_first:
            grad_feat.zero_()
        stream = torch.cuda.current_stream().cuda_stream
        code = lib.bilinear_sample_bwd(feat.data_ptr(), points.data_ptr(), grad_out.data_ptr(),
                                       grad_feat.data_ptr(), grad_points.data_ptr(), b, h, w, c,
                                       n, stream)
        if code != 0:
            raise RuntimeError(f"bilinear_sample_bwd returned {code}")
        return grad_feat, grad_points

    return fwd, bwd


def device_ms(fn, iters):
    """Device ms a call of ``fn``: every kernel and memset of a
    torch.profiler session of ``iters`` calls, over ``iters``; a session
    that sees no device time is taken again, up to 4 in all."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    for _ in range(4):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        busy = sum(evt.self_device_time_total for evt in prof.key_averages())
        if busy > 0:
            return busy / 1e3 / iters
    raise RuntimeError("torch.profiler saw no device time in 4 sessions")


def main(argv=None) -> int:
    args = parse_args(argv)
    sys.path.insert(0, os.getcwd())
    import chip_smoke as cs

    if not torch.cuda.is_available():
        print("sampler_ab times the card's kernels: no CUDA device", file=sys.stderr)
        return 2
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip().splitlines()[0]
    print(card, flush=True)
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=_build.BUILD_DIR) as tmp:
        this, other = build_other(args.other, tmp)
    gen = torch.Generator(device="cuda").manual_seed(21)
    cases = [(label, hwc, *cs.sampler_inputs(torch, gen, hwc, out_hw, stride), count)
             for label, hwc, out_hw, stride, count in cs.DCN_SAMPLERS]
    cases.append((*cs.sampler_wide_inputs(torch, gen), 0))
    rows, ok = [], True
    for label, hwc, feat, points, count in cases:
        grad_out = torch.randn(points.shape[:2] + hwc[2:], device="cuda", generator=gen)
        want = gs.bilinear_sample_reference(feat, points)
        want_grads = gs.bilinear_sample_backward_reference(feat, points, grad_out)
        calls = {"other": launchers(other, True, feat, points, grad_out),
                 "this": launchers(this, False, feat, points, grad_out)}
        row = dict(shape=label, map=list(hwc), samples=points.shape[1], count=count)
        outs = {}
        for name, (fwd, bwd) in calls.items():
            outs[name] = fwd().clone()
            grads = [g.clone() for g in bwd()]
            torch.cuda.synchronize()
            try:
                err, grad_err, _ = cs.sampler_errors(torch, f"{name} {label}", outs[name], want,
                                                     grads, want_grads)
                row[f"{name}_max_abs_err"] = [err, *grad_err]
            except AssertionError as exc:
                print(f"FAILED {exc}", flush=True)
                ok = False
        row["forward_bitwise_equal"] = torch.equal(outs["other"].nan_to_num(7.0),
                                                   outs["this"].nan_to_num(7.0))
        for kind, index in (("fwd", 0), ("bwd", 1)):
            times = {"other": [], "this": []}
            for _ in range(args.rounds):
                for name in ("other", "this", "this", "other"):
                    times[name].append(device_ms(calls[name][index], args.iters))
            for name, ms in times.items():
                row[f"{name}_{kind}_ms"] = sum(ms) / len(ms)
        n, c = points.shape[1], hwc[2]
        row["fwd_bound_ms"] = cs.bound(cs.size(feat, points, want), 8 * n * c)[0]
        row["bwd_bound_ms"] = cs.bound(cs.size(grad_out, feat, points) + cs.size(feat, points),
                                       24 * n * c)[0]
        rows.append(row)
        print(f"{label} ({'x'.join(map(str, hwc))} at {n} points, {count} a forward): "
              + "; ".join(f"{kind} device ms a launch: other {row[f'other_{kind}_ms']:.4f}, "
                          f"this {row[f'this_{kind}_ms']:.4f}, bound {row[f'{kind}_bound_ms']:.4f}"
                          for kind in ("fwd", "bwd"))
              + f"; forward outputs equal bit for bit: {row['forward_bitwise_equal']}", flush=True)
        del feat, points, grad_out, want, want_grads, calls, outs
    totals = {key: sum(r[key] * r["count"] for r in rows)
              for key in ("other_fwd_ms", "this_fwd_ms", "other_bwd_ms", "this_bwd_ms")}
    print(f"over a forward's {sum(r['count'] for r in rows)} DCNs, device ms: forward other "
          f"{totals['other_fwd_ms']:.4f}, this {totals['this_fwd_ms']:.4f}; backward other "
          f"{totals['other_bwd_ms']:.4f}, this {totals['this_bwd_ms']:.4f}", flush=True)
    if args.json:
        with open(args.json, "w") as f:
            json.dump(dict(card=card, other=args.other, iters=args.iters, rounds=args.rounds,
                           rows=rows, totals=totals, ok=ok), f, indent=1)
    print(json.dumps(dict(ok=ok, **totals)))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
