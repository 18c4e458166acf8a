"""Image decode for the port's data path: JPEG with nvJPEG on the card (EXIF
on the host), PNG on the host with zlib and numpy.

The counterpart of the JAX package's ``cv2.imdecode(data, IMREAD_COLOR)``
followed by BGR->RGB (``relation_detr_tpu/data/coco.py:133-135``): JPEG
bytes in, an RGB (H, W, 3) uint8 array on the host out, turned upright by
the file's EXIF Orientation tag as cv2 turns it. nvJPEG from the CUDA
toolkit decodes (``csrc/jpeg_decode.cu``, built by ``_build`` at the first
decode). For YCbCr at 4:4:4, 4:2:2 and 4:2:0 it returns the planes, and
``ycc_to_rgb`` (a kernel of that file; plain version
``ycc_to_rgb_reference``) upsamples the chroma and converts to RGB with
libjpeg-turbo's arithmetic, which cv2 decodes with. Other chroma
subsamplings take nvJPEG's RGB; grayscale files come out as three equal
channels, as cv2 gives them; a file nvJPEG cannot decode (CMYK, a broken
stream) raises ``UnreadableImage`` with its name.

PNG files decode on the host (``decode_png``: stdlib ``zlib`` and numpy) to
what cv2's ``IMREAD_COLOR`` followed by BGR->RGB gives: 8-bit grey, RGB,
RGBA (alpha dropped, not composited) and palette images, 1-, 2- and 4-bit
grey and palette, 16-bit samples cut to their high byte, all five row
filters. Adam7-interlaced files and PNG EXIF orientation are not ported:
an interlaced file raises ``UnreadableImage`` with its name.

On the CPU there is no JPEG decoder: a caller passes ``decode=`` (a function
of the file's bytes that returns the RGB array), and without it a JPEG
raises. A card is never bypassed for the CPU. A file that is neither JPEG
nor PNG, or that its decoder cannot read, raises ``UnreadableImage`` (a
``ValueError``); a CUDA error raises ``RuntimeError``.
"""
from __future__ import annotations

import ctypes
import functools
import struct
import threading
import zlib
from contextlib import contextmanager
from typing import Callable, Optional

import numpy as np
import torch

from relation_detr_tpu_torch import _build

Decode = Callable[[np.ndarray], np.ndarray]

# nvjpegChromaSubsampling_t -> the chroma upsampling factors (hf, vf) that
# ycc_to_rgb takes: 4:4:4, 4:2:2, 4:2:0; grayscale; the subsamplings that
# take nvJPEG's own RGB conversion (4:4:0, 4:1:1, 4:1:0, 4:1:0V)
_FANCY = {0: (1, 1), 1: (2, 1), 2: (2, 2)}
_GRAY = 6
_NVJPEG_RGB = (3, 4, 5, 7)
_FORMAT_RGB, _FORMAT_Y, _FORMAT_YUV = 0, 1, 2  # jpeg_decode's output formats
_ORIENTATION_TAG = 0x0112
# nvjpegStatus_t values that mean the file, not the card or the library
_NVJPEG_BAD_FILE = (3, 4)  # NVJPEG_STATUS_BAD_JPEG, NVJPEG_STATUS_JPEG_NOT_SUPPORTED
PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"


class UnreadableImage(ValueError):
    """A file the port's decoders cannot read (broken, or a format or
    variant they do not decode); the message names the file."""


def exif_orientation(data) -> int:
    """The EXIF Orientation (1-8) of JPEG bytes, 1 when absent or invalid.

    Walks the markers from SOI to the first SOS and reads tag 0x0112 of IFD0
    in an ``Exif`` APP1 segment (TIFF header, either byte order)."""
    buf = bytes(memoryview(data)[:65536 * 4])
    if buf[:2] != b"\xff\xd8":
        return 1
    pos = 2
    while pos + 4 <= len(buf):
        if buf[pos] != 0xFF:
            return 1
        marker = buf[pos + 1]
        if marker == 0xFF:  # fill byte
            pos += 1
            continue
        if marker == 0xDA or marker == 0xD9:  # SOS / EOI: no more headers
            return 1
        (length,) = struct.unpack(">H", buf[pos + 2:pos + 4])
        seg = buf[pos + 4:pos + 2 + length]
        if marker == 0xE1 and seg[:6] == b"Exif\x00\x00":
            return _tiff_orientation(seg[6:])
        pos += 2 + length
    return 1


def _tiff_orientation(tiff: bytes) -> int:
    if len(tiff) < 8 or tiff[:2] not in (b"II", b"MM"):
        return 1
    order = "<" if tiff[:2] == b"II" else ">"
    (ifd,) = struct.unpack(order + "I", tiff[4:8])
    if ifd + 2 > len(tiff):
        return 1
    (count,) = struct.unpack(order + "H", tiff[ifd:ifd + 2])
    for i in range(count):
        entry = tiff[ifd + 2 + 12 * i:ifd + 14 + 12 * i]
        if len(entry) < 12:
            return 1
        tag, kind = struct.unpack(order + "HH", entry[:4])
        if tag == _ORIENTATION_TAG and kind == 3:  # SHORT, value in the entry
            (value,) = struct.unpack(order + "H", entry[8:10])
            return value if 1 <= value <= 8 else 1
    return 1


def apply_orientation(image: np.ndarray, orientation: int) -> np.ndarray:
    """The stored (H, W, C) pixels turned upright for an EXIF Orientation,
    as PIL's ``ImageOps.exif_transpose`` and cv2's ``IMREAD_COLOR`` do."""
    ops = {
        1: lambda x: x,
        2: lambda x: x[:, ::-1],  # mirror left-right
        3: lambda x: x[::-1, ::-1],  # rotate 180
        4: lambda x: x[::-1],  # mirror top-bottom
        5: lambda x: x.transpose(1, 0, 2),  # transpose
        6: lambda x: np.rot90(x, -1),  # rotate 90 clockwise
        7: lambda x: x.transpose(1, 0, 2)[::-1, ::-1],  # transverse
        8: lambda x: np.rot90(x, 1),  # rotate 90 counter-clockwise
    }
    return np.ascontiguousarray(ops[orientation](image))


def _upsample_reference(c: torch.Tensor, h: int, w: int, hf: int, vf: int) -> torch.Tensor:
    """libjpeg-turbo's fancy upsampling (jdsample.c h2v1/h2v2) of a (ch, cw)
    uint8 plane to (h, w) int32: each output takes 3/4 of the nearer and 1/4
    of the further sample per upsampled axis, image edges replicated."""
    c = c.to(torch.int32)
    ch, cw = c.shape
    if (hf, vf) == (1, 1):
        return c
    if vf == 2:  # column sums over the nearer and the further row, x4
        r = torch.arange(h, device=c.device)
        near = r // 2
        far = torch.where(r % 2 == 0, (near - 1).clamp(min=0), (near + 1).clamp(max=ch - 1))
        c = 3 * c[near] + c[far]
        shift, round_even, round_odd = 4, 8, 7
    else:
        shift, round_even, round_odd = 2, 1, 2
    x = torch.arange(w, device=c.device)
    col = x // 2
    even = x % 2 == 0
    other = torch.where(even, (col - 1).clamp(min=0), (col + 1).clamp(max=cw - 1))
    rounding = torch.where(even, round_even, round_odd)
    return (3 * c[:, col] + c[:, other] + rounding) >> shift


def ycc_to_rgb_reference(y: torch.Tensor, cb: torch.Tensor, cr: torch.Tensor, hf: int,
                         vf: int) -> torch.Tensor:
    """Plain version of ``ycc_to_rgb``: libjpeg-turbo's fancy chroma
    upsampling, then its fixed-point YCbCr -> RGB (jdcolor.c: 16 fraction
    bits, FIX(x) = round(x * 65536)), clamped to 0..255."""
    h, w = y.shape
    luma = y.to(torch.int32)
    cb = _upsample_reference(cb, h, w, hf, vf) - 128
    cr = _upsample_reference(cr, h, w, hf, vf) - 128
    rgb = torch.stack([luma + ((91881 * cr + 32768) >> 16),
                       luma + ((-22554 * cb + 32768 - 46802 * cr) >> 16),
                       luma + ((116130 * cb + 32768) >> 16)], dim=-1)
    return rgb.clamp(0, 255).to(torch.uint8)


def _check_planes(y, cb, cr, hf, vf) -> None:
    if (hf, vf) not in _FANCY.values():
        raise ValueError(f"ycc_to_rgb: chroma factors {(hf, vf)} not in {list(_FANCY.values())}")
    for name, t in (("y", y), ("cb", cb), ("cr", cr)):
        if t.dtype != torch.uint8 or t.dim() != 2 or not t.is_contiguous():
            raise ValueError(f"ycc_to_rgb: {name} must be a contiguous 2-D uint8 tensor")
        if t.device != y.device:
            raise ValueError("ycc_to_rgb: planes on different devices")
    h, w = y.shape
    if cb.shape != cr.shape or tuple(cb.shape) != (-(-h // vf), -(-w // hf)):
        raise ValueError(f"ycc_to_rgb: chroma planes {tuple(cb.shape)} / {tuple(cr.shape)} do "
                         f"not match luma {(h, w)} at factors {(hf, vf)}")


def ycc_to_rgb(y: torch.Tensor, cb: torch.Tensor, cr: torch.Tensor, hf: int,
               vf: int) -> torch.Tensor:
    """Y (h, w), Cb and Cr (ceil(h / vf), ceil(w / hf)) uint8 planes -> RGB
    (h, w, 3) uint8, as libjpeg-turbo (cv2) upsamples and converts. A CUDA
    tensor launches ``ycc_to_rgb_kernel`` (``csrc/jpeg_decode.cu``) on the
    current stream, a CPU tensor takes ``ycc_to_rgb_reference``.
    ``ycc_to_rgb.launches`` counts the kernel's launches, the decoder's
    among them (it calls this wrapper)."""
    _check_planes(y, cb, cr, hf, vf)
    if y.device.type != "cuda":
        return ycc_to_rgb_reference(y, cb, cr, hf, vf)
    lib = _build.load_jpeg_library()
    h, w = y.shape
    out = torch.empty((h, w, 3), dtype=torch.uint8, device=y.device)
    code = lib.ycc_to_rgb(y.data_ptr(), cb.data_ptr(), cr.data_ptr(), out.data_ptr(), h, w,
                          cb.shape[0], cb.shape[1], hf, vf,
                          torch.cuda.current_stream(y.device).cuda_stream)
    if code != 0:
        raise RuntimeError(f"ycc_to_rgb launch failed (code {code}: "
                           f"{lib.jpeg_error_string(code).decode()})")
    ycc_to_rgb.launches += 1
    return out


ycc_to_rgb.launches = 0


class _State:
    """One nvJPEG decode state and its stream, used by one thread at a time."""

    def __init__(self, ptr: ctypes.c_void_p, stream):
        self.ptr = ptr
        self.stream = stream


class NvJpegDecoder:
    """nvJPEG decoder on one card: one library handle for every thread and a
    pool of decode states (nvJPEG state and stream), each used by one thread
    at a time. nvJPEG decodes into device planes on the state's stream;
    YCbCr planes then go through ``ycc_to_rgb`` on that stream, and the RGB
    array comes to the host there, which waits for that stream only."""

    def __init__(self, device: int):
        self._lib = _build.load_jpeg_library()
        self.device = torch.device("cuda", device)
        handle = ctypes.c_void_p()
        self._check(self._lib.jpeg_handle_create(ctypes.byref(handle)), "nvJPEG handle")
        self._handle = handle
        self._free = []
        self._lock = threading.Lock()

    def _check(self, code: int, what: str) -> None:
        if code != 0:
            msg = f"{what}: JPEG decode failed (code {code}: " \
                  f"{self._lib.jpeg_error_string(code).decode()})"
            raise UnreadableImage(msg) if code in _NVJPEG_BAD_FILE else RuntimeError(msg)

    @contextmanager
    def _state(self):
        """A state from the pool, its stream the current one meanwhile."""
        with self._lock:
            state = self._free.pop() if self._free else None
        if state is None:
            ptr = ctypes.c_void_p()
            self._check(self._lib.jpeg_state_create(self._handle, self.device.index,
                                                    ctypes.byref(ptr)), "nvJPEG state")
            stream = torch.cuda.ExternalStream(self._lib.jpeg_state_stream(ptr),
                                               device=self.device)
            state = _State(ptr, stream)
        try:
            with torch.cuda.stream(state.stream):
                yield state
        finally:
            with self._lock:
                self._free.append(state)

    def info(self, data: np.ndarray, name: str):
        """(components, nvJPEG chroma subsampling, height, width, chroma
        height, chroma width) of JPEG bytes."""
        info = np.zeros(6, np.int32)
        self._check(self._lib.jpeg_image_info(self._handle, data.ctypes.data, data.size,
                                              info.ctypes.data), name)
        return tuple(int(v) for v in info)

    def _decode_into(self, state: _State, data: np.ndarray, name: str, fmt: int,
                     planes) -> None:
        args = []
        for p in planes + [None] * (3 - len(planes)):
            args += [None, 0] if p is None else [p.data_ptr(), p.stride(0)]
        self._check(self._lib.jpeg_decode(self._handle, state.ptr, data.ctypes.data, data.size,
                                          fmt, *args), name)

    def _planes(self, state: _State, data: np.ndarray, name: str, info):
        _, subsampling, h, w, ch, cw = info
        hf, vf = _FANCY[subsampling]
        if (ch, cw) != (-(-h // vf), -(-w // hf)):
            raise RuntimeError(f"{name}: nvJPEG's chroma planes {(ch, cw)} do not match the "
                               f"image {(h, w)} at factors {(hf, vf)}")
        planes = [torch.empty(shape, dtype=torch.uint8, device=self.device)
                  for shape in ((h, w), (ch, cw), (ch, cw))]
        self._decode_into(state, data, name, _FORMAT_YUV, planes)
        return planes, (hf, vf)

    def planes(self, data: np.ndarray, name: str):
        """The Y, Cb and Cr device planes nvJPEG decodes a YCbCr JPEG at
        4:4:4, 4:2:2 or 4:2:0 to (``decode`` hands them to ``ycc_to_rgb``),
        and the chroma factors (hf, vf); ready on the current stream."""
        data = np.ascontiguousarray(data, np.uint8)
        info = self.info(data, name)
        if info[0] != 3 or info[1] not in _FANCY:
            raise ValueError(f"{name}: not YCbCr at 4:4:4, 4:2:2 or 4:2:0")
        with self._state() as state:
            planes, factors = self._planes(state, data, name, info)
            state.stream.synchronize()
        for p in planes:  # the caller's stream uses them from here on
            p.record_stream(torch.cuda.current_stream(self.device))
        return (*planes, factors)

    def decode(self, data: np.ndarray, name: str) -> np.ndarray:
        """JPEG bytes (a uint8 array) -> RGB (H, W, 3) uint8 on the host,
        stored orientation (``decode_image`` applies EXIF)."""
        data = np.ascontiguousarray(data, np.uint8)
        info = self.info(data, name)
        components, subsampling, h, w = info[:4]
        if components == 1 or subsampling == _GRAY:
            with self._state() as state:
                luma = torch.empty((h, w), dtype=torch.uint8, device=self.device)
                self._decode_into(state, data, name, _FORMAT_Y, [luma])
                return np.repeat(luma.cpu().numpy()[..., None], 3, axis=2)
        if components != 3 or (subsampling not in _FANCY and subsampling not in _NVJPEG_RGB):
            raise UnreadableImage(f"{name}: JPEG with {components} components and chroma "
                               f"subsampling {subsampling} is not decoded by nvJPEG here "
                               "(grayscale and YCbCr are)")
        with self._state() as state:
            if subsampling in _NVJPEG_RGB:
                rgb = torch.empty((h, w, 3), dtype=torch.uint8, device=self.device)
                self._decode_into(state, data, name, _FORMAT_RGB, [rgb])
            else:
                planes, factors = self._planes(state, data, name, info)
                rgb = ycc_to_rgb(*planes, *factors)
            return rgb.cpu().numpy()  # waits for the state's stream only


@functools.lru_cache(maxsize=None)
def nvjpeg_decoder(device: int) -> NvJpegDecoder:
    """The process's decoder for card ``device`` (one nvJPEG handle)."""
    return NvJpegDecoder(device)


def decode_image(data: np.ndarray, name: str, device="cuda",
                 decode: Optional[Decode] = None) -> np.ndarray:
    """JPEG or PNG bytes -> upright RGB (H, W, 3) uint8 on the host.

    ``decode`` replaces the decoder (the CPU tests pass cv2's); without it
    a PNG decodes on the host (``decode_png``) and a JPEG with nvJPEG on
    ``device``, which must be a card. ``name`` labels every error."""
    if decode is not None:
        return decode(data)
    if bytes(data[:8]) == PNG_SIGNATURE:
        return decode_png(data, name)
    if bytes(data[:2]) != b"\xff\xd8":
        raise UnreadableImage(f"{name}: not a JPEG or PNG file")
    device = torch.device(device)
    if device.type != "cuda":
        raise RuntimeError(f"{name}: no JPEG decoder on {device}; decode on a card or pass "
                           "decode=")
    index = device.index if device.index is not None else torch.cuda.current_device()
    image = nvjpeg_decoder(index).decode(data, name)
    return apply_orientation(image, exif_orientation(data))


def read_image(path: str, device="cuda", decode: Optional[Decode] = None) -> np.ndarray:
    """``decode_image`` of a file."""
    return decode_image(np.fromfile(path, np.uint8), path, device, decode)


def _unfilter(raw: np.ndarray, h: int, stride: int, bpp: int, name: str) -> np.ndarray:
    """The (h, stride) bytes of PNG scanlines with their filters (None, Sub,
    Up, Average, Paeth) undone; ``bpp`` is the filter's byte distance."""
    raw = raw.reshape(h, stride + 1)
    out = np.zeros((h, stride), np.uint8)
    prior = np.zeros(stride, np.int64)
    for y in range(h):
        kind, line = raw[y, 0], raw[y, 1:].astype(np.int64)
        if kind == 0:
            row = line
        elif kind == 1:  # Sub: a running sum per byte of the pixel
            row = np.zeros(stride, np.int64)
            for k in range(bpp):
                row[k::bpp] = np.cumsum(line[k::bpp])
        elif kind == 2:  # Up
            row = line + prior
        elif kind in (3, 4):  # Average, Paeth: each byte depends on the one bpp left
            row = line.tolist()
            up = prior.tolist()
            for i in range(stride):
                a = row[i - bpp] if i >= bpp else 0
                if kind == 3:
                    row[i] = (row[i] + ((a + up[i]) >> 1)) & 255
                    continue
                b, c = up[i], (up[i - bpp] if i >= bpp else 0)
                pa, pb, pc = abs(b - c), abs(a - c), abs(a + b - 2 * c)
                row[i] = (row[i] + (a if pa <= pb and pa <= pc else b if pb <= pc else c)) & 255
            row = np.asarray(row, np.int64)
        else:
            raise UnreadableImage(f"{name}: PNG row filter {kind} is not one of 0-4")
        prior = row & 255
        out[y] = prior
    return out


def decode_png(data, name: str) -> np.ndarray:
    """PNG bytes -> RGB (H, W, 3) uint8, as cv2's ``IMREAD_COLOR`` followed
    by BGR->RGB decodes them: grey as three equal channels (1-, 2-, 4-bit
    grey scaled to 0-255), palette entries looked up, the alpha channel and
    ``tRNS`` dropped, 16-bit samples cut to their high byte."""
    buf = bytes(memoryview(data))
    if buf[:8] != PNG_SIGNATURE:
        raise UnreadableImage(f"{name}: not a PNG file")
    pos, idat, header, palette = 8, [], None, None
    while pos + 8 <= len(buf):
        length, kind = struct.unpack(">I4s", buf[pos:pos + 8])
        body = buf[pos + 8:pos + 8 + length]
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body[:13])
        elif kind == b"PLTE":
            palette = np.frombuffer(body, np.uint8).reshape(-1, 3)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
        pos += 12 + length
    if header is None or not idat:
        raise UnreadableImage(f"{name}: PNG without IHDR or IDAT")
    w, h, depth, color, _, _, interlace = header
    if interlace:
        raise UnreadableImage(f"{name}: Adam7-interlaced PNG is not decoded by the port")
    channels = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}.get(color)
    if channels is None or depth not in (1, 2, 4, 8, 16) or (color == 3 and palette is None):
        raise UnreadableImage(f"{name}: PNG colour type {color} at {depth} bits is not valid")
    try:
        raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    except zlib.error as exc:
        raise UnreadableImage(f"{name}: PNG data does not inflate ({exc})") from None
    bits = channels * depth
    stride = (w * bits + 7) // 8
    if raw.size < h * (stride + 1):
        raise UnreadableImage(f"{name}: PNG data is short")
    rows = _unfilter(raw[:h * (stride + 1)], h, stride, max(bits // 8, 1), name)
    if depth == 16:
        samples = rows.reshape(h, w * channels, 2)[..., 0]  # the high byte
    elif depth == 8:
        samples = rows
    else:  # 1, 2 or 4 bits: unpack, most significant first
        shifts = np.arange(8 - depth, -1, -depth)
        samples = ((rows[..., None] >> shifts) & ((1 << depth) - 1)).reshape(h, -1)[:, :w]
        if color == 0:
            samples = (samples * (255 // ((1 << depth) - 1))).astype(np.uint8)
    samples = samples.reshape(h, w, channels)
    if color == 3:
        index = samples[..., 0]
        if index.max() >= len(palette):
            raise UnreadableImage(f"{name}: PNG palette index past the palette")
        return np.ascontiguousarray(palette[index])
    if channels <= 2:  # grey (+ alpha)
        return np.ascontiguousarray(np.repeat(samples[..., :1], 3, axis=2))
    return np.ascontiguousarray(samples[..., :3])
