"""Build and load the package's CUDA kernels.

``nvcc`` compiles every ``csrc/*.cu`` to an object file, one process per
source, all started together, and links them into one shared library with a
plain C interface, which is loaded with ``ctypes`` (no PyTorch headers, so a
build takes seconds). The library lands in ``build/relation_detr_tpu_torch/`` at
the repository root, named by a hash of the sources and flags, so a changed
source rebuilds and an unchanged one is reused. Nothing is built or loaded
when this module is imported: ``load_library`` runs at a wrapper's first
launch on a CUDA tensor.

Flags: ``sm_90a`` (Hopper), ``-O3`` and NO ``--use_fast_math`` — the relation
kernel's angles reach ~1.8e3 rad, where the fast ``__sinf``/``__cosf`` lose
accuracy.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "build" / "relation_detr_tpu_torch"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
)


def find_nvcc() -> str:
    for cand in (
        shutil.which("nvcc"),
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
    ):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError(
        "nvcc not found (PATH, $CUDA_HOME/bin): the CUDA kernels of "
        "relation_detr_tpu_torch cannot be built"
    )


def _sources():
    return sorted(p for p in CSRC.iterdir() if p.suffix in (".cu", ".cuh", ".h"))


def library_path() -> Path:
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources():
        digest.update(src.name.encode())
        digest.update(src.read_bytes())
    return BUILD_DIR / f"librdetr_kernels_{digest.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the kernels unless a library for these sources exists."""
    out = library_path()
    if out.is_file():
        return out
    nvcc = find_nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tag = f"tmp{os.getpid()}"
    tmp = out.with_suffix(f".{tag}.so")
    objs, procs = [], []
    for src in (p for p in _sources() if p.suffix == ".cu"):
        obj = BUILD_DIR / f"{src.stem}.{tag}.o"
        objs.append(obj)
        procs.append((src.name, subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-c", "-o", str(obj), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )))
    try:
        logs = [(name, proc.communicate()[0], proc.returncode) for name, proc in procs]
        failed = [(name, code, log) for name, log, code in logs if code != 0]
        if not failed:
            link = subprocess.run(
                [nvcc, *NVCC_FLAGS, "-shared", "-o", str(tmp), *map(str, objs)],
                capture_output=True, text=True,
            )
            if link.returncode != 0:
                failed = [("link", link.returncode, link.stdout + link.stderr)]
        if failed:
            tmp.unlink(missing_ok=True)
            raise RuntimeError("nvcc failed:\n" + "\n".join(
                f"{name} ({code}):\n{log}" for name, code, log in failed))
        os.replace(tmp, out)
    finally:
        for obj in objs:
            obj.unlink(missing_ok=True)
    return out


_P = ctypes.c_void_p
_I = ctypes.c_int64


@functools.lru_cache(maxsize=None)
def load_library() -> ctypes.CDLL:
    """Build (if needed) and load the kernels; declares every C entry."""
    lib = ctypes.CDLL(str(build()))
    # int msda_fwd(value, level_hw (host int64 [2L]), loc, attn, out,
    #              B, S, Q, H, D, L, P, stream)
    lib.msda_fwd.argtypes = [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P]
    lib.msda_fwd.restype = ctypes.c_int
    # int msda_bwd(value, level_hw (host int64 [2L]), loc, attn, grad_out,
    #              grad_value, grad_loc, grad_attn, B, S, Q, H, D, L, P, stream)
    lib.msda_bwd.argtypes = [_P, _P, _P, _P, _P, _P, _P, _P,
                             _I, _I, _I, _I, _I, _I, _I, _P]
    lib.msda_bwd.restype = ctypes.c_int
    # int window_accumulate(g, y0s, x0s (device int32 [nt]), out,
    #                       nt, ph, pw, C, h, w, stream)
    lib.window_accumulate.argtypes = [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P]
    lib.window_accumulate.restype = ctypes.c_int
    # int relation_bias_v4_fwd(src, tgt, a_feats, b_feats, w_xy, bias, freqs
    #                          (host float [E/2]), out, B, N1, N2, H, E, eps, stream)
    lib.relation_bias_v4_fwd.argtypes = [
        _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, ctypes.c_float, _P,
    ]
    lib.relation_bias_v4_fwd.restype = ctypes.c_int
    lib.rdetr_error_string.argtypes = [ctypes.c_int]
    lib.rdetr_error_string.restype = ctypes.c_char_p
    return lib


def check(lib: ctypes.CDLL, code: int, name: str) -> None:
    """Raise if a C entry returned a CUDA error (its cudaGetLastError())."""
    if code != 0:
        msg = lib.rdetr_error_string(code).decode()
        raise RuntimeError(f"{name} launch failed: CUDA error {code} ({msg})")
