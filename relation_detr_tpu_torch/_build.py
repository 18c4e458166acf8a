"""Build and load the package's CUDA libraries.

Two shared libraries with a plain C interface, loaded with ``ctypes`` (no
PyTorch headers, so a build takes seconds):

- the kernels: every ``csrc/*.cu`` but the decoder's;
- the JPEG decoder: ``csrc/jpeg_decode.cu``, linked with ``-lnvjpeg`` (only
  this library needs nvJPEG, so the kernels load without it).

``nvcc`` compiles each source to an object file, one process per source, all
started together (``build_all`` starts both libraries' at once), and links
each library. A library lands in ``build/relation_detr_tpu_torch/`` at the
repository root, named by a hash of its sources and flags, so a changed
source rebuilds and an unchanged one is reused. Nothing is built or loaded
when this module is imported: ``load_library`` runs at a wrapper's first
launch on a CUDA tensor, ``load_jpeg_library`` at the first decode.

Flags: ``sm_90a`` (Hopper), ``-O3`` and NO ``--use_fast_math`` — the relation
kernel's angles reach ~1.8e3 rad, where the fast ``__sinf``/``__cosf`` lose
accuracy.
"""
from __future__ import annotations

import ctypes
import functools
import glob
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
JPEG_SOURCE = "jpeg_decode.cu"


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


def cuda_home() -> str:
    return os.environ.get("CUDA_HOME", "/usr/local/cuda")


def nvjpeg_dir() -> str:
    """The directory that holds the toolkit's libnvjpeg.so."""
    for cand in (os.path.join(cuda_home(), "lib64"),
                 *sorted(glob.glob(os.path.join(cuda_home(), "targets", "*", "lib")))):
        if os.path.isfile(os.path.join(cand, "libnvjpeg.so")):
            return cand
    raise RuntimeError(f"libnvjpeg.so not found under {cuda_home()}: the JPEG decoder of "
                       "relation_detr_tpu_torch cannot be built")


def _sources(name: str):
    """The sources (with headers) of library ``name``: "kernels" or "jpeg"."""
    srcs = sorted(p for p in CSRC.iterdir() if p.suffix in (".cu", ".cuh", ".h"))
    if name == "jpeg":
        return [p for p in srcs if p.name == JPEG_SOURCE]
    return [p for p in srcs if p.name != JPEG_SOURCE]


def _library_path(name: str) -> Path:
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources(name):
        digest.update(src.name.encode())
        digest.update(src.read_bytes())
    stem = "librdetr_kernels" if name == "kernels" else "librdetr_jpeg"
    return BUILD_DIR / f"{stem}_{digest.hexdigest()[:16]}.so"


def library_path() -> Path:
    return _library_path("kernels")


def jpeg_library_path() -> Path:
    return _library_path("jpeg")


def _link_flags(name: str):
    if name == "jpeg":
        return ("-L", nvjpeg_dir(), "-lnvjpeg")
    return ()


def _build(names) -> None:
    """Compile the libraries ``names`` that are not built yet: every source's
    nvcc started at once, then one link per library."""
    todo = [n for n in names if not _library_path(n).is_file()]
    if not todo:
        return
    nvcc = find_nvcc()
    link_flags = {n: _link_flags(n) for n in todo}
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tag = f"tmp{os.getpid()}"
    objs, procs = {n: [] for n in todo}, []
    for name in todo:
        for src in (p for p in _sources(name) if p.suffix == ".cu"):
            obj = BUILD_DIR / f"{src.stem}.{tag}.o"
            objs[name].append(obj)
            procs.append((src.name, subprocess.Popen(
                [nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-c", "-o", str(obj), str(src)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            )))
    tmps = []
    try:
        logs = [(name, proc.communicate()[0], proc.returncode) for name, proc in procs]
        failed = [(name, code, log) for name, log, code in logs if code != 0]
        for name in todo if not failed else ():
            out = _library_path(name)
            tmp = out.with_suffix(f".{tag}.so")
            tmps.append(tmp)
            link = subprocess.run(
                [nvcc, *NVCC_FLAGS, "-shared", "-o", str(tmp), *map(str, objs[name]),
                 *link_flags[name]],
                capture_output=True, text=True,
            )
            if link.returncode != 0:
                failed = [(f"link {name}", link.returncode, link.stdout + link.stderr)]
                break
            os.replace(tmp, out)
        if failed:
            raise RuntimeError("nvcc failed:\n" + "\n".join(
                f"{name} ({code}):\n{log}" for name, code, log in failed))
    finally:
        for path in (*(o for group in objs.values() for o in group), *tmps):
            path.unlink(missing_ok=True)


def build() -> Path:
    """Compile the kernels unless a library for these sources exists."""
    _build(("kernels",))
    return library_path()


def build_all() -> None:
    """Compile the kernels and the JPEG decoder, all sources at once."""
    _build(("kernels", "jpeg"))


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
    # the bf16-value forms: value, out and grad_out bf16; msda_bwd_bf16 takes
    # an fp32 accumulator (grad_acc) before the bf16 grad_value
    lib.msda_fwd_bf16.argtypes = lib.msda_fwd.argtypes
    lib.msda_fwd_bf16.restype = ctypes.c_int
    # int msda_bwd_bf16(value, level_hw, loc, attn, grad_out, grad_acc,
    #                   grad_value, grad_loc, grad_attn, B, S, Q, H, D, L, P, stream)
    lib.msda_bwd_bf16.argtypes = [_P, _P, _P, _P, _P, _P, _P, _P, _P,
                                  _I, _I, _I, _I, _I, _I, _I, _P]
    lib.msda_bwd_bf16.restype = ctypes.c_int
    # int window_accumulate(g, offsets (device int32 [positions + 1]),
    #                       rows (device int32 [nt * ph * pw]), out, positions, C, stream)
    lib.window_accumulate.argtypes = [_P, _P, _P, _P, _I, _I, _P]
    lib.window_accumulate.restype = ctypes.c_int
    # int relation_bias_v4_fwd(src, tgt, w, w_stride_f, w_stride_h, bias, freqs
    #                          (host float [E/2]), out, B, N1, N2, H, E, eps, stream)
    lib.relation_bias_v4_fwd.argtypes = [
        _P, _P, _P, _I, _I, _P, _P, _P, _I, _I, _I, _I, _I, ctypes.c_float, _P,
    ]
    lib.relation_bias_v4_fwd.restype = ctypes.c_int
    # int relation_bias_rel_fwd(rel, w, bias, freqs (host float [E/2]), out,
    #                           B, N1, N2, H, E, stream)
    lib.relation_bias_rel_fwd.argtypes = [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P]
    lib.relation_bias_rel_fwd.restype = ctypes.c_int
    # int tiled_core_fwd(m, w, patch, out, B, nt, H, E, T, M, C, stream)
    lib.tiled_core_fwd.argtypes = [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P]
    lib.tiled_core_fwd.restype = ctypes.c_int
    # int tiled_core_bwd(m, w, patch, g, dw, dpatch, B, nt, H, E, T, M, C, stream)
    lib.tiled_core_bwd.argtypes = [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P]
    lib.tiled_core_bwd.restype = ctypes.c_int
    # int sep_contract_fwd(oy, ox, patch, out, B, nt, H, P, ph, pw, T, C, stream)
    lib.sep_contract_fwd.argtypes = [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _P]
    lib.sep_contract_fwd.restype = ctypes.c_int
    lib.rdetr_error_string.argtypes = [ctypes.c_int]
    lib.rdetr_error_string.restype = ctypes.c_char_p
    return lib


@functools.lru_cache(maxsize=None)
def load_jpeg_library() -> ctypes.CDLL:
    """Build (if needed) and load the JPEG decoder; declares every C entry.
    The toolkit's libnvjpeg is loaded first, so that the loader finds it
    wherever the toolkit lies."""
    _build(("jpeg",))
    ctypes.CDLL(os.path.join(nvjpeg_dir(), "libnvjpeg.so"), mode=ctypes.RTLD_GLOBAL)
    lib = ctypes.CDLL(str(jpeg_library_path()))
    lib.jpeg_handle_create.argtypes = [ctypes.POINTER(_P)]
    lib.jpeg_handle_destroy.argtypes = [_P]
    # int jpeg_state_create(handle, device, state out)
    lib.jpeg_state_create.argtypes = [_P, _I, ctypes.POINTER(_P)]
    lib.jpeg_state_destroy.argtypes = [_P]
    # int jpeg_image_info(handle, data, length, info (host int32 [6]))
    lib.jpeg_image_info.argtypes = [_P, _P, _I, _P]
    # void *jpeg_state_stream(state)
    lib.jpeg_state_stream.argtypes = [_P]
    lib.jpeg_state_stream.restype = _P
    # int jpeg_decode(handle, state, data, length, format, plane 0, pitch 0,
    #                 plane 1, pitch 1, plane 2, pitch 2)  (device planes)
    lib.jpeg_decode.argtypes = [_P, _P, _P, _I, _I, _P, _I, _P, _I, _P, _I]
    # int ycc_to_rgb(y, cb, cr, out, height, width, chroma height, chroma width,
    #                hf, vf, stream)
    lib.ycc_to_rgb.argtypes = [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P]
    for fn in (lib.jpeg_handle_create, lib.jpeg_handle_destroy, lib.jpeg_state_create,
               lib.jpeg_state_destroy, lib.jpeg_image_info, lib.jpeg_decode, lib.ycc_to_rgb):
        fn.restype = ctypes.c_int
    lib.jpeg_error_string.argtypes = [ctypes.c_int]
    lib.jpeg_error_string.restype = ctypes.c_char_p
    return lib


def check(lib: ctypes.CDLL, code: int, name: str) -> None:
    """Raise if a C entry returned a CUDA error (its cudaGetLastError())."""
    if code != 0:
        msg = lib.rdetr_error_string(code).decode()
        raise RuntimeError(f"{name} launch failed: CUDA error {code} ({msg})")
