"""PNG input/output with numpy and ``zlib`` alone.

Counterpart of ``zraytrace_tpu/io/png.py``, which uses Pillow. The port
runs on machines without Pillow, so this module decodes and encodes the
format itself. It reads what the scenes use — 8-bit, non-interlaced RGB
(colour type 2) and RGBA (colour type 6), with any of the five scanline
filters — and writes 8-bit RGB.

The reference's buffer conventions are kept exactly:

- rows are stored bottom-up in memory: the reader flips vertically
  (png_image.zig:86) and the writer flips back (png_image.zig:136),
- quantization is ``trunc(clamp(255.999 * c, 0, 255))``
  (png_image.zig:138-140),
- only the RGB channels are kept; alpha is dropped (png_image.zig:44-59).
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

from zraytrace_tpu_torch.profiling import span

_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_CHANNELS = {2: 3, 6: 4}  # colour type -> samples per pixel


def _chunks(data: bytes):
    pos = len(_SIGNATURE)
    while pos + 8 <= len(data):
        (n,) = struct.unpack(">I", data[pos:pos + 4])
        kind = data[pos + 4:pos + 8]
        yield kind, data[pos + 8:pos + 8 + n]
        pos += 12 + n  # length, type, payload, crc
        if kind == b"IEND":
            return


def _unfilter(raw: bytes, h: int, w: int, bpp: int) -> np.ndarray:
    """Undo the per-scanline filters (PNG spec section 9) -> (h, w, bpp) u8.

    Average and Paeth are sequential along a row and down a column, so the
    pixels are reconstructed one anti-diagonal ``x + y = t`` at a time:
    everything a pixel depends on (left, up, up-left) lies on an earlier
    diagonal, and each diagonal is one vectorized step over all rows.
    """
    data = np.frombuffer(raw, np.uint8).reshape(h, w * bpp + 1)
    ftype = data[:, 0].astype(np.int32)
    if ftype.max() > 4:
        raise ValueError(f"unknown PNG filter type {ftype.max()}")
    filt = data[:, 1:].astype(np.int32).reshape(h, w, bpp)
    # one row and one column of zeros above / left of the image
    out = np.zeros((h + 1, w + 1, bpp), np.int32)
    rows = np.arange(h)
    for t in range(w + h - 1):
        r = rows[max(0, t - w + 1):min(h, t + 1)]
        x = t - r
        a = out[r + 1, x]  # left
        b = out[r, x + 1]  # up
        c = out[r, x]  # up-left
        p = a + b - c
        pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
        paeth = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))
        ft = ftype[r][:, None]
        pred = np.where(ft == 1, a, np.where(ft == 2, b, np.where(
            ft == 3, (a + b) >> 1, np.where(ft == 4, paeth, 0))))
        out[r + 1, x + 1] = (filt[r, x] + pred) & 255
    return out[1:, 1:].astype(np.uint8)


def decode_png(data: bytes) -> np.ndarray:
    """PNG bytes -> ``(H, W, C)`` u8 in file row order (row 0 = top)."""
    if data[:8] != _SIGNATURE:
        raise ValueError("not a PNG file")
    header = None
    idat = []
    for kind, payload in _chunks(data):
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", payload)
        elif kind == b"IDAT":
            idat.append(payload)
    if header is None:
        raise ValueError("PNG without IHDR")
    w, h, depth, ctype, _comp, _filter, interlace = header
    if depth != 8 or ctype not in _CHANNELS or interlace != 0:
        raise ValueError(
            f"unsupported PNG: bit depth {depth}, colour type {ctype}, "
            f"interlace {interlace} (8-bit non-interlaced RGB/RGBA only)")
    return _unfilter(zlib.decompress(b"".join(idat)), h, w, _CHANNELS[ctype])


@span("io.png")
def read_png(path) -> np.ndarray:
    """Read a PNG into ``(H, W, 3)`` f32 in [0, 1], row 0 = image bottom."""
    with open(path, "rb") as f:
        pixels = decode_png(f.read())
    arr = pixels[..., :3].astype(np.float32) / 255.0
    return arr[::-1].copy()


def quantize(image: np.ndarray) -> np.ndarray:
    """Float image -> uint8 with the reference's clamp (png_image.zig:138)."""
    return np.clip(255.999 * image, 0.0, 255.0).astype(np.uint8)


def _chunk(kind: bytes, payload: bytes) -> bytes:
    crc = zlib.crc32(kind + payload) & 0xFFFFFFFF
    return struct.pack(">I", len(payload)) + kind + payload + struct.pack(">I", crc)


def encode_png(pixels: np.ndarray) -> bytes:
    """``(H, W, 3)`` u8 (row 0 = top) -> PNG bytes, filter type 0."""
    h, w, _ = pixels.shape
    rows = np.concatenate(
        [np.zeros((h, 1), np.uint8), np.ascontiguousarray(pixels).reshape(h, w * 3)],
        axis=1)
    header = struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)
    return (_SIGNATURE + _chunk(b"IHDR", header)
            + _chunk(b"IDAT", zlib.compress(rows.tobytes(), 6))
            + _chunk(b"IEND", b""))


def write_png(path, image) -> None:
    """Write ``(H, W, 3)`` f32 (row 0 = bottom) as an 8-bit RGB PNG."""
    data = quantize(np.asarray(image))[::-1]
    with open(path, "wb") as f:
        f.write(encode_png(data))
