"""Image decode for the port's data path: JPEG with nvJPEG on the card (EXIF
on the host), PNG on the host with zlib and numpy.

The counterpart of the JAX package's ``cv2.imdecode(data, IMREAD_COLOR)``
followed by BGR->RGB (``relation_detr_tpu/data/coco.py:133-135``): JPEG
bytes in, an RGB (H, W, 3) uint8 array on the host out, turned upright by
the file's EXIF Orientation tag as cv2 turns it. nvJPEG from the CUDA
toolkit decodes (``csrc/jpeg_decode.cu``, built by ``_build`` at the first
decode). For YCbCr at 4:4:4, 4:2:2, 4:2:0, 4:4:0, 4:1:1 and 4:1:0 it returns
the planes, and ``ycc_to_rgb`` (a kernel of that file; plain version
``ycc_to_rgb_reference``) upsamples the chroma and converts to RGB with
libjpeg-turbo's arithmetic, which cv2 decodes with: its fancy upsampling
(h2v1, h2v2, h1v2) where libjpeg has one, plain replication for 4:1:1 and
4:1:0. nvJPEG's "4:1:0V" takes nvJPEG's own RGB; grayscale files come out
as three equal channels, as cv2 gives them. Four-component files (Adobe
CMYK and YCCK) come as nvJPEG's four planes, which ``cmyk_to_rgb``
converts as libjpeg and cv2 do (YCCK's YCbCr -> RGB with ``ycc_to_rgb``
on the card, the CMYK -> RGB on the host). A file nvJPEG cannot decode
(a broken stream, four components with subsampled planes) raises
``UnreadableImage`` with its name.

PNG files decode on the host (``decode_png``: stdlib ``zlib`` and numpy) to
what cv2's ``IMREAD_COLOR`` followed by BGR->RGB gives: 8-bit grey, RGB,
RGBA (alpha dropped, not composited) and palette images, 1-, 2- and 4-bit
grey and palette, 16-bit samples cut to their high byte, all five row
filters, Adam7 interlacing, and the orientation of an ``eXIf`` chunk.

The writers are host code, the counterpart of ``cv2.imwrite`` of a BGR
uint8 image (``write_image``, by the file's extension): ``encode_jpeg``,
libjpeg's baseline 4:2:0 JFIF with its standard Huffman tables over the
coefficients of ``cv_ops.jpeg_coefficients`` (cv2 decodes the file to
``cv_ops.jpeg_roundtrip``'s pixels), and ``encode_png`` (8-bit RGB, zlib).

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
# ycc_to_rgb takes: 4:4:4, 4:2:2, 4:2:0, 4:4:0, 4:1:1, 4:1:0; grayscale; the
# subsampling that takes nvJPEG's own RGB conversion (4:1:0V)
_FANCY = {0: (1, 1), 1: (2, 1), 2: (2, 2), 3: (1, 2), 4: (4, 1), 5: (4, 2)}
_GRAY = 6
_NVJPEG_RGB = (7,)
# jpeg_decode's output formats: interleaved RGB, luma, the 3 YCbCr planes,
# every component's plane as stored (a four-component file's four)
_FORMAT_RGB, _FORMAT_Y, _FORMAT_YUV, _FORMAT_UNCHANGED = 0, 1, 2, 3
_ORIENTATION_TAG = 0x0112
# nvjpegStatus_t values that mean the file, not the card or the library
_NVJPEG_BAD_FILE = (3, 4)  # NVJPEG_STATUS_BAD_JPEG, NVJPEG_STATUS_JPEG_NOT_SUPPORTED
PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"


class UnreadableImage(ValueError):
    """A file the port's decoders cannot read (broken, or a format or
    variant they do not decode); the message names the file."""


def _header_segments(data):
    """(marker, body) of each segment of JPEG bytes from SOI to the first
    SOS (nothing for bytes that are not a JPEG)."""
    buf = bytes(memoryview(data)[:65536 * 4])
    if buf[:2] != b"\xff\xd8":
        return
    pos = 2
    while pos + 4 <= len(buf):
        if buf[pos] != 0xFF:
            return
        marker = buf[pos + 1]
        if marker == 0xFF:  # fill byte
            pos += 1
            continue
        if marker == 0xDA or marker == 0xD9:  # SOS / EOI: no more headers
            return
        (length,) = struct.unpack(">H", buf[pos + 2:pos + 4])
        yield marker, buf[pos + 4:pos + 2 + length]
        pos += 2 + length


def exif_orientation(data) -> int:
    """The EXIF Orientation (1-8) of JPEG bytes, 1 when absent or invalid.

    Walks the markers from SOI to the first SOS and reads tag 0x0112 of IFD0
    in an ``Exif`` APP1 segment (TIFF header, either byte order)."""
    for marker, seg in _header_segments(data):
        if marker == 0xE1 and seg[:6] == b"Exif\x00\x00":
            return _tiff_orientation(seg[6:])
    return 1


def adobe_transform(data) -> Optional[int]:
    """The transform flag of JPEG bytes' Adobe APP14 segment (libjpeg reads
    a four-component file as CMYK at 0 or without the segment, as YCCK
    otherwise), None without one."""
    for marker, seg in _header_segments(data):
        if marker == 0xEE and len(seg) >= 12 and seg[:5] == b"Adobe":
            return seg[11]
    return None


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
    """libjpeg-turbo's upsampling (jdsample.c) of a (ch, cw) uint8 plane to
    (h, w) int32. Fancy for h2v1, h2v2 and h1v2: each output takes 3/4 of
    the nearer and 1/4 of the further sample per upsampled axis, image edges
    replicated; plain replication (int_upsample) for 4:1:1 and 4:1:0."""
    c = c.to(torch.int32)
    ch, cw = c.shape
    if (hf, vf) == (1, 1):
        return c
    r = torch.arange(h, device=c.device)
    if hf == 4:
        return c[r // vf][:, torch.arange(w, device=c.device) // 4]
    if vf == 2:  # column sums over the nearer and the further row
        near = r // 2
        far = torch.where(r % 2 == 0, (near - 1).clamp(min=0), (near + 1).clamp(max=ch - 1))
        c = 3 * c[near] + c[far]
        if hf == 1:  # h1v2: the sums, x4
            return (c + torch.where(r % 2 == 0, 1, 2)[:, None]) >> 2
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
    """Plain version of ``ycc_to_rgb``: libjpeg-turbo's chroma upsampling
    (``_upsample_reference``), then its fixed-point YCbCr -> RGB (jdcolor.c:
    16 fraction bits, FIX(x) = round(x * 65536)), clamped to 0..255."""
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


def cmyk_to_rgb(planes: torch.Tensor, transform: Optional[int]) -> np.ndarray:
    """A four-component JPEG's decoded planes (4, H, W) uint8, on the card
    or the CPU -> RGB (H, W, 3) uint8 on the host, as cv2's
    ``IMREAD_COLOR`` gives it. ``transform`` is the file's Adobe APP14 flag
    (``adobe_transform``): with 0 or no segment libjpeg reads the planes as
    CMYK as they are, with another flag as YCCK, which it turns into CMYK
    (jdcolor.c ycck_cmyk_convert: the YCbCr -> RGB of the first three
    planes, inverted; K as it is). That YCbCr -> RGB is ``ycc_to_rgb`` at
    (1, 1) where the planes lie: its kernel on the card, its plain version
    on the CPU. cv2 then takes the CMYK as Adobe's inverted samples
    (``icvCvt_CMYK2BGR``, host code): R = K - ((255 - C) K >> 8), G and B
    likewise from M and Y."""
    if planes.dtype != torch.uint8 or planes.dim() != 3 or planes.shape[0] != 4:
        raise ValueError(f"cmyk_to_rgb takes (4, H, W) uint8 planes, got {planes.dtype} "
                         f"{tuple(planes.shape)}")
    planes = planes.contiguous()
    if transform in (None, 0):
        cmy = planes[:3].permute(1, 2, 0).cpu().numpy().astype(np.int32)
    else:  # on the card, .cpu() waits for the current stream
        cmy = 255 - ycc_to_rgb(planes[0], planes[1], planes[2], 1, 1).cpu().numpy().astype(
            np.int32)
    k = planes[3].cpu().numpy().astype(np.int32)[..., None]
    return (k - (((255 - cmy) * k) >> 8)).astype(np.uint8)


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
        """(components, nvJPEG chroma subsampling, height, width, then the
        height and width of components 1, 2 and 3 (0 where absent)) of JPEG
        bytes."""
        info = np.zeros(10, np.int32)
        self._check(self._lib.jpeg_image_info(self._handle, data.ctypes.data, data.size,
                                              info.ctypes.data), name)
        return tuple(int(v) for v in info)

    def _decode_into(self, state: _State, data: np.ndarray, name: str, fmt: int,
                     planes) -> None:
        args = []
        for p in planes + [None] * (4 - len(planes)):
            args += [None, 0] if p is None else [p.data_ptr(), p.stride(0)]
        self._check(self._lib.jpeg_decode(self._handle, state.ptr, data.ctypes.data, data.size,
                                          fmt, *args), name)

    def _planes(self, state: _State, data: np.ndarray, name: str, info):
        _, subsampling, h, w, ch, cw = info[:6]
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
        4:4:4, 4:2:2, 4:2:0, 4:4:0, 4:1:1 or 4:1:0 to (``decode`` hands them
        to ``ycc_to_rgb``), and the chroma factors (hf, vf); ready on the
        current stream."""
        data = np.ascontiguousarray(data, np.uint8)
        info = self.info(data, name)
        if info[0] != 3 or info[1] not in _FANCY:
            raise ValueError(f"{name}: not YCbCr at a subsampling ycc_to_rgb takes")
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
        if components == 4:
            return self._decode_cmyk(data, name, info)
        if components != 3 or (subsampling not in _FANCY and subsampling not in _NVJPEG_RGB):
            raise UnreadableImage(f"{name}: JPEG with {components} components and chroma "
                                  f"subsampling {subsampling} is not decoded by nvJPEG here "
                                  "(grayscale, YCbCr, CMYK and YCCK are)")
        with self._state() as state:
            if subsampling in _NVJPEG_RGB:
                rgb = torch.empty((h, w, 3), dtype=torch.uint8, device=self.device)
                self._decode_into(state, data, name, _FORMAT_RGB, [rgb])
            else:
                planes, factors = self._planes(state, data, name, info)
                rgb = ycc_to_rgb(*planes, *factors)
            return rgb.cpu().numpy()  # waits for the state's stream only

    def _decode_cmyk(self, data: np.ndarray, name: str, info) -> np.ndarray:
        """A four-component file: nvJPEG's four planes as stored, converted
        by the file's Adobe transform flag (``cmyk_to_rgb``: a YCCK file's
        YCbCr -> RGB with ``ycc_to_rgb``'s kernel on the state's stream,
        the CMYK -> RGB on the host)."""
        h, w = info[2:4]
        sizes = [tuple(info[2 + 2 * i:4 + 2 * i]) for i in range(4)]
        if any(hw != (h, w) for hw in sizes):
            raise UnreadableImage(f"{name}: four-component JPEG with subsampled planes "
                                  f"{sizes} is not decoded by the port")
        with self._state() as state:
            planes = torch.empty((4, h, w), dtype=torch.uint8, device=self.device)
            self._decode_into(state, data, name, _FORMAT_UNCHANGED, list(planes))
            return cmyk_to_rgb(planes, adobe_transform(data))  # waits for the state's stream


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


# Adam7's seven passes: (x0, y0, dx, dy) of the pixels each one holds
_ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4), (0, 2, 2, 4), (1, 0, 2, 2),
          (0, 1, 1, 2))


def _png_samples(raw: np.ndarray, h: int, w: int, depth: int, channels: int, color: int,
                 name: str):
    """The (h, w, channels) uint8 samples of an image (or an Adam7 pass) from
    its filtered scanlines at the start of ``raw``, and the bytes they took:
    rows unfiltered, 1-, 2- and 4-bit samples unpacked (grey scaled to
    0-255), 16-bit ones cut to their high byte."""
    bits = channels * depth
    stride = (w * bits + 7) // 8
    size = h * (stride + 1)
    if raw.size < size:
        raise UnreadableImage(f"{name}: PNG data is short")
    rows = _unfilter(raw[:size], h, stride, max(bits // 8, 1), name)
    if depth == 16:
        samples = rows.reshape(h, w * channels, 2)[..., 0]  # the high byte
    elif depth == 8:
        samples = rows
    else:  # 1, 2 or 4 bits: unpack, most significant first
        shifts = np.arange(8 - depth, -1, -depth)
        samples = ((rows[..., None] >> shifts) & ((1 << depth) - 1)).reshape(h, -1)[:, :w]
        if color == 0:
            samples = (samples * (255 // ((1 << depth) - 1))).astype(np.uint8)
    return samples.reshape(h, w, channels), size


def decode_png(data, name: str) -> np.ndarray:
    """PNG bytes -> RGB (H, W, 3) uint8, as cv2's ``IMREAD_COLOR`` followed
    by BGR->RGB decodes them: grey as three equal channels (1-, 2-, 4-bit
    grey scaled to 0-255), palette entries looked up, the alpha channel and
    ``tRNS`` dropped, 16-bit samples cut to their high byte; Adam7's passes
    put back in place; turned upright by the Orientation of an ``eXIf``
    chunk (``apply_orientation``), before or after the image data."""
    buf = bytes(memoryview(data))
    if buf[:8] != PNG_SIGNATURE:
        raise UnreadableImage(f"{name}: not a PNG file")
    pos, idat, header, palette, orientation = 8, [], None, None, 1
    while pos + 8 <= len(buf):
        length, kind = struct.unpack(">I4s", buf[pos:pos + 8])
        body = buf[pos + 8:pos + 8 + length]
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body[:13])
        elif kind == b"PLTE":
            palette = np.frombuffer(body, np.uint8).reshape(-1, 3)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"eXIf":
            orientation = _tiff_orientation(body)
        elif kind == b"IEND":
            break
        pos += 12 + length
    if header is None or not idat:
        raise UnreadableImage(f"{name}: PNG without IHDR or IDAT")
    w, h, depth, color, _, _, interlace = header
    channels = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}.get(color)
    if channels is None or depth not in (1, 2, 4, 8, 16) or (color == 3 and palette is None):
        raise UnreadableImage(f"{name}: PNG colour type {color} at {depth} bits is not valid")
    if interlace not in (0, 1):
        raise UnreadableImage(f"{name}: PNG interlace method {interlace} is not valid")
    try:
        raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    except zlib.error as exc:
        raise UnreadableImage(f"{name}: PNG data does not inflate ({exc})") from None
    if not interlace:
        samples, _ = _png_samples(raw, h, w, depth, channels, color, name)
    else:  # each pass its own rows, filters and packing
        samples = np.zeros((h, w, channels), np.uint8)
        offset = 0
        for x0, y0, dx, dy in _ADAM7:
            pw, ph = -(-(w - x0) // dx), -(-(h - y0) // dy)
            if pw > 0 and ph > 0:  # an empty pass has no bytes, not even filter bytes
                samples[y0::dy, x0::dx], size = _png_samples(raw[offset:], ph, pw, depth,
                                                             channels, color, name)
                offset += size
    if color == 3:
        index = samples[..., 0]
        if index.max() >= len(palette):
            raise UnreadableImage(f"{name}: PNG palette index past the palette")
        image = palette[index]
    elif channels <= 2:  # grey (+ alpha)
        image = np.repeat(samples[..., :1], 3, axis=2)
    else:
        image = samples[..., :3]
    return apply_orientation(image, orientation)


# --------------------------------------------------------------------------
# writers: baseline JPEG (libjpeg's layout and standard tables) and PNG

def _zigzag() -> np.ndarray:
    """Natural (row-major 8x8) index of each zigzag position."""
    order = sorted(((r + c, c if (r + c) % 2 == 0 else r, r * 8 + c)
                    for r in range(8) for c in range(8)))
    return np.asarray([k for _, _, k in order])


ZIGZAG = _zigzag()
# JPEG Annex K.3: (counts of the codes of each length 1-16, symbols)
_DC_LUMA = ((0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0), tuple(range(12)))
_DC_CHROMA = ((0, 3, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0), tuple(range(12)))
_AC_LUMA = ((0, 2, 1, 3, 3, 2, 4, 3, 5, 5, 4, 4, 0, 0, 1, 0x7d), (
    0x01, 0x02, 0x03, 0x00, 0x04, 0x11, 0x05, 0x12, 0x21, 0x31, 0x41, 0x06, 0x13, 0x51, 0x61,
    0x07, 0x22, 0x71, 0x14, 0x32, 0x81, 0x91, 0xa1, 0x08, 0x23, 0x42, 0xb1, 0xc1, 0x15, 0x52,
    0xd1, 0xf0, 0x24, 0x33, 0x62, 0x72, 0x82, 0x09, 0x0a, 0x16, 0x17, 0x18, 0x19, 0x1a, 0x25,
    0x26, 0x27, 0x28, 0x29, 0x2a, 0x34, 0x35, 0x36, 0x37, 0x38, 0x39, 0x3a, 0x43, 0x44, 0x45,
    0x46, 0x47, 0x48, 0x49, 0x4a, 0x53, 0x54, 0x55, 0x56, 0x57, 0x58, 0x59, 0x5a, 0x63, 0x64,
    0x65, 0x66, 0x67, 0x68, 0x69, 0x6a, 0x73, 0x74, 0x75, 0x76, 0x77, 0x78, 0x79, 0x7a, 0x83,
    0x84, 0x85, 0x86, 0x87, 0x88, 0x89, 0x8a, 0x92, 0x93, 0x94, 0x95, 0x96, 0x97, 0x98, 0x99,
    0x9a, 0xa2, 0xa3, 0xa4, 0xa5, 0xa6, 0xa7, 0xa8, 0xa9, 0xaa, 0xb2, 0xb3, 0xb4, 0xb5, 0xb6,
    0xb7, 0xb8, 0xb9, 0xba, 0xc2, 0xc3, 0xc4, 0xc5, 0xc6, 0xc7, 0xc8, 0xc9, 0xca, 0xd2, 0xd3,
    0xd4, 0xd5, 0xd6, 0xd7, 0xd8, 0xd9, 0xda, 0xe1, 0xe2, 0xe3, 0xe4, 0xe5, 0xe6, 0xe7, 0xe8,
    0xe9, 0xea, 0xf1, 0xf2, 0xf3, 0xf4, 0xf5, 0xf6, 0xf7, 0xf8, 0xf9, 0xfa))
_AC_CHROMA = ((0, 2, 1, 2, 4, 4, 3, 4, 7, 5, 4, 4, 0, 1, 2, 0x77), (
    0x00, 0x01, 0x02, 0x03, 0x11, 0x04, 0x05, 0x21, 0x31, 0x06, 0x12, 0x41, 0x51, 0x07, 0x61,
    0x71, 0x13, 0x22, 0x32, 0x81, 0x08, 0x14, 0x42, 0x91, 0xa1, 0xb1, 0xc1, 0x09, 0x23, 0x33,
    0x52, 0xf0, 0x15, 0x62, 0x72, 0xd1, 0x0a, 0x16, 0x24, 0x34, 0xe1, 0x25, 0xf1, 0x17, 0x18,
    0x19, 0x1a, 0x26, 0x27, 0x28, 0x29, 0x2a, 0x35, 0x36, 0x37, 0x38, 0x39, 0x3a, 0x43, 0x44,
    0x45, 0x46, 0x47, 0x48, 0x49, 0x4a, 0x53, 0x54, 0x55, 0x56, 0x57, 0x58, 0x59, 0x5a, 0x63,
    0x64, 0x65, 0x66, 0x67, 0x68, 0x69, 0x6a, 0x73, 0x74, 0x75, 0x76, 0x77, 0x78, 0x79, 0x7a,
    0x82, 0x83, 0x84, 0x85, 0x86, 0x87, 0x88, 0x89, 0x8a, 0x92, 0x93, 0x94, 0x95, 0x96, 0x97,
    0x98, 0x99, 0x9a, 0xa2, 0xa3, 0xa4, 0xa5, 0xa6, 0xa7, 0xa8, 0xa9, 0xaa, 0xb2, 0xb3, 0xb4,
    0xb5, 0xb6, 0xb7, 0xb8, 0xb9, 0xba, 0xc2, 0xc3, 0xc4, 0xc5, 0xc6, 0xc7, 0xc8, 0xc9, 0xca,
    0xd2, 0xd3, 0xd4, 0xd5, 0xd6, 0xd7, 0xd8, 0xd9, 0xda, 0xe2, 0xe3, 0xe4, 0xe5, 0xe6, 0xe7,
    0xe8, 0xe9, 0xea, 0xf2, 0xf3, 0xf4, 0xf5, 0xf6, 0xf7, 0xf8, 0xf9, 0xfa))


def _huffman_codes(table):
    """(code, length) arrays indexed by symbol: the canonical codes of
    Annex C."""
    counts, symbols = table
    code, codes, lengths, k = 0, np.zeros(256, np.int64), np.zeros(256, np.int64), 0
    for length, n in enumerate(counts, start=1):
        for _ in range(n):
            codes[symbols[k]], lengths[symbols[k]] = code, length
            code, k = code + 1, k + 1
        code <<= 1
    return codes, lengths


def _magnitude(v: np.ndarray):
    """JPEG's size category and extra bits of each value."""
    a = np.abs(v)
    size = np.zeros_like(a)
    for bit in range(16):
        size += (a >> bit) > 0
    return size, np.where(v < 0, v + (1 << size) - 1, v)


def _entropy_code(blocks: np.ndarray, table_ids: np.ndarray, components: np.ndarray) -> bytes:
    """Huffman-coded scan of quantised blocks (N, 64, zigzag order) in
    stream order: DC differences per component, AC run lengths with ZRL
    and EOB; byte-stuffed, the last byte filled with ones."""
    n = len(blocks)
    dc = blocks[:, 0]
    diff = np.empty(n, np.int64)
    for c in np.unique(components):
        at = np.nonzero(components == c)[0]
        diff[at] = np.diff(dc[at], prepend=0)
    tables = [(_huffman_codes(_DC_LUMA), _huffman_codes(_AC_LUMA)),
              (_huffman_codes(_DC_CHROMA), _huffman_codes(_AC_CHROMA))]

    def symbol_codes(kind, symbol, tid):
        code, length = np.zeros_like(symbol), np.zeros_like(symbol)
        for t, pair in enumerate(tables):
            at = tid == t
            code[at], length[at] = pair[kind][0][symbol[at]], pair[kind][1][symbol[at]]
        return code, length

    items = []  # (block, key, value, bits): key orders the items of a block

    def add(block, key, code, length, extra=None, size=None):
        value = code if extra is None else (code << size) | extra
        items.append((block, key, value, length if size is None else length + size))

    size, extra = _magnitude(diff)
    add(np.arange(n), np.zeros(n, np.int64), *symbol_codes(0, size, table_ids), extra, size)
    b, k = np.nonzero(blocks[:, 1:])
    k = k + 1
    first = np.ones(len(b), bool)
    first[1:] = b[1:] != b[:-1]
    prev = np.where(first, 0, np.concatenate([[0], k[:-1]]))
    run = k - prev - 1
    zrl = run // 16
    if zrl.any():  # runs of 16 zeros before the coefficient
        at = np.repeat(np.arange(len(b)), zrl)
        sub = np.arange(len(at)) - np.repeat(np.cumsum(zrl) - zrl, zrl)
        add(b[at], k[at] * 32 + sub, *symbol_codes(1, np.full(len(at), 0xF0), table_ids[b[at]]))
    size, extra = _magnitude(blocks[b, k])
    add(b, k * 32 + 16, *symbol_codes(1, ((run % 16) << 4) | size, table_ids[b]), extra, size)
    last = np.full(n, 0)
    last[b] = k  # the last nonzero coefficient of each block
    eob = np.nonzero(last < 63)[0]
    add(eob, np.full(len(eob), 64 * 32), *symbol_codes(1, np.zeros(len(eob), np.int64),
                                                          table_ids[eob]))
    block, key, value, bits = (np.concatenate(x) for x in zip(*items))
    order = np.lexsort((key, block))
    value, bits = value[order], bits[order]
    pos = np.arange(bits.max(initial=1))
    stream = ((value[:, None] >> (bits[:, None] - 1 - pos)) & 1)[pos < bits[:, None]]
    stream = np.concatenate([stream, np.ones(-len(stream) % 8, np.int64)]).astype(np.uint8)
    data = np.packbits(stream)
    return np.insert(data, np.nonzero(data == 0xFF)[0] + 1, 0).tobytes()


def _segment(marker: int, body: bytes) -> bytes:
    return struct.pack(">HH", marker, len(body) + 2) + body


def encode_jpeg(bgr: np.ndarray, quality: int = 95) -> bytes:
    """``cv2.imencode(".jpg", bgr, [IMWRITE_JPEG_QUALITY, quality])`` of an
    (H, W, 3) uint8 BGR image, byte for byte: a baseline JFIF file at 4:2:0
    with libjpeg's quality-scaled standard quantisation tables and its
    standard Huffman tables, laid out as libjpeg writes it."""
    from relation_detr_tpu_torch.data.cv_ops import jpeg_coefficients

    if bgr.dtype != np.uint8 or bgr.ndim != 3 or bgr.shape[2] != 3:
        raise ValueError(f"encode_jpeg takes an (H, W, 3) uint8 image, got {bgr.dtype} "
                         f"{bgr.shape}")
    h, w = bgr.shape[:2]
    if not (0 < h < 65536 and 0 < w < 65536):
        raise ValueError(f"encode_jpeg: {h}x{w} is not a JPEG size")
    luma_q, chroma_q, (y, cb, cr) = jpeg_coefficients(bgr, quality)
    # libjpeg's dummy luma blocks past the image (jccoefct.c): zero AC, the
    # DC of the block to the left, or in an MCU's bottom row its top-right
    # block's; the decoder crops them, and cv2 writes the same bytes
    real_rows, real_cols = -(-h // 8), -(-w // 8)
    y = y.copy()
    y[:real_rows, real_cols:] = 0
    y[:real_rows, real_cols:, 0, 0] = y[:real_rows, real_cols - 1:real_cols, 0, 0]
    y[real_rows:] = 0
    y[real_rows:, :, 0, 0] = np.repeat(y[real_rows - 1:real_rows, 1::2, 0, 0], 2, axis=1)
    rows, cols = cb.shape[:2]
    y = y.reshape(rows, 2, cols, 2, 64).transpose(0, 2, 1, 3, 4).reshape(rows, cols, 4, 64)
    mcus = np.concatenate([y, cb.reshape(rows, cols, 1, 64), cr.reshape(rows, cols, 1, 64)],
                          axis=2)  # per MCU: Y00 Y01 Y10 Y11 Cb Cr
    blocks = mcus.reshape(-1, 64)[:, ZIGZAG]
    components = np.tile(np.asarray([0, 0, 0, 0, 1, 2]), rows * cols)
    scan = _entropy_code(blocks, np.minimum(components, 1), components)
    out = [b"\xff\xd8", _segment(0xFFE0, b"JFIF\x00\x01\x01\x00\x00\x01\x00\x01\x00\x00")]
    for tid, table in enumerate((luma_q, chroma_q)):
        out.append(_segment(0xFFDB, bytes([tid]) + table.reshape(64)[ZIGZAG].astype(
            np.uint8).tobytes()))
    out.append(_segment(0xFFC0, struct.pack(">BHHB", 8, h, w, 3)
                        + bytes([1, 0x22, 0, 2, 0x11, 1, 3, 0x11, 1])))
    for tclass, tid, (counts, symbols) in ((0, 0, _DC_LUMA), (1, 0, _AC_LUMA),
                                           (0, 1, _DC_CHROMA), (1, 1, _AC_CHROMA)):
        out.append(_segment(0xFFC4, bytes([tclass << 4 | tid, *counts, *symbols])))
    out.append(_segment(0xFFDA, bytes([3, 1, 0x00, 2, 0x11, 3, 0x11, 0, 63, 0])))
    out += [scan, b"\xff\xd9"]
    return b"".join(out)


def _png_chunk(kind: bytes, body: bytes) -> bytes:
    return struct.pack(">I", len(body)) + kind + body + struct.pack(
        ">I", zlib.crc32(kind + body) & 0xFFFFFFFF)


def encode_png(img: np.ndarray) -> bytes:
    """``cv2.imencode(".png", img)`` of an (H, W, 3) uint8 BGR image (an 8-bit
    RGB file) or an (H, W) one (8-bit grey): no row filter, zlib."""
    if img.dtype != np.uint8 or not (img.ndim == 2 or (img.ndim == 3 and img.shape[2] == 3)):
        raise ValueError(f"encode_png takes an (H, W) or (H, W, 3) uint8 image, got "
                         f"{img.dtype} {img.shape}")
    h, w = img.shape[:2]
    pixels = img if img.ndim == 2 else img[..., ::-1]
    raw = np.concatenate([np.zeros((h, 1), np.uint8), pixels.reshape(h, -1)], axis=1)
    header = struct.pack(">IIBBBBB", w, h, 8, 0 if img.ndim == 2 else 2, 0, 0, 0)
    return b"".join([PNG_SIGNATURE, _png_chunk(b"IHDR", header),
                     _png_chunk(b"IDAT", zlib.compress(raw.tobytes(), 6)),
                     _png_chunk(b"IEND", b"")])


def write_image(path: str, img: np.ndarray, quality: int = 95) -> None:
    """``cv2.imwrite(path, img)`` of a BGR uint8 image, the format by the
    extension: ``.jpg`` / ``.jpeg`` (``encode_jpeg`` at ``quality``, cv2's
    default 95) or ``.png``; any other raises ``ValueError``."""
    ext = path.lower().rsplit(".", 1)[-1] if "." in path else ""
    if ext in ("jpg", "jpeg"):
        data = encode_jpeg(img, quality)
    elif ext == "png":
        data = encode_png(img)
    else:
        raise ValueError(f"{path}: the port writes .jpg, .jpeg and .png files only")
    with open(path, "wb") as f:
        f.write(data)
