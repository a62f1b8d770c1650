"""PNG reader on the standard library's zlib and numpy.

The logged replays this package reads hold non-interlaced 8-bit RGB
(`*_rgb.png`) and 16-bit gray (`*_depth`, `*_ht`, `*_no_ht`) PNGs; a host
with neither OpenCV nor Pillow must still read them.  Supported: 8- and
16-bit gray and RGB, all five row filters (None and Sub rows are undone
for the whole image at once, Up row by row, Average and Paeth pixel by
pixel).  Interlaced, palette, alpha and sub-byte files raise ValueError.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_CHANNELS = {0: 1, 2: 3}  # color type -> channels (gray, RGB)


def _parse(data: bytes):
    if data[:8] != _SIGNATURE:
        raise ValueError("not a PNG file")
    pos, header, idat = 8, None, []
    while pos + 8 <= len(data):
        length, tag = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + length]
        pos += 12 + length
        if tag == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif tag == b"IDAT":
            idat.append(body)
        elif tag == b"IEND":
            break
    if header is None or not idat:
        raise ValueError("PNG without IHDR or IDAT")
    return header, b"".join(idat)


def _unfilter_row(ftype: int, cur: np.ndarray, prev: np.ndarray, bpp: int):
    """Undo an Up, Average or Paeth filter on one row (uint8), given the
    reconstructed previous row."""
    if ftype == 2:  # Up
        return cur + prev
    out = cur.astype(np.int16)
    up = prev.astype(np.int16)
    for j in range(0, out.size, bpp):
        left = out[j - bpp:j] if j else np.zeros(bpp, np.int16)
        if ftype == 3:  # Average
            pred = (left + up[j:j + bpp]) // 2
        elif ftype == 4:  # Paeth
            ul = up[j - bpp:j] if j else np.zeros(bpp, np.int16)
            b = up[j:j + bpp]
            p = left + b - ul
            pa, pb, pc = np.abs(p - left), np.abs(p - b), np.abs(p - ul)
            pred = np.where((pa <= pb) & (pa <= pc), left, np.where(pb <= pc, b, ul))
        else:
            raise ValueError(f"unknown PNG filter type {ftype}")
        out[j:j + bpp] = (out[j:j + bpp] + pred) & 0xFF
    return out.astype(np.uint8)


def read_png(path: str) -> np.ndarray:
    """Decode a PNG: uint8 or uint16 [H, W] (gray) or [H, W, 3] (RGB)."""
    with open(path, "rb") as f:
        header, payload = _parse(f.read())
    width, height, depth, color, _, _, interlace = header
    if interlace:
        raise ValueError(f"{path}: interlaced PNG is not supported")
    if depth not in (8, 16) or color not in _CHANNELS:
        raise ValueError(
            f"{path}: only 8/16-bit gray or RGB PNGs are supported "
            f"(bit depth {depth}, color type {color})"
        )
    ch = _CHANNELS[color]
    bpp = ch * depth // 8
    stride = width * bpp
    raw = np.frombuffer(zlib.decompress(payload), np.uint8)
    if raw.size != height * (stride + 1):
        raise ValueError(f"{path}: truncated image data")
    raw = raw.reshape(height, stride + 1)
    ftypes = raw[:, 0]
    img = raw[:, 1:].copy()

    # None and Sub rows depend on no other row: undo them all at once
    # (Sub is a per-channel running sum mod 256 along the row)
    sub = ftypes == 1
    if sub.any():
        img[sub] = np.cumsum(
            img[sub].reshape(-1, width, bpp), axis=1, dtype=np.uint8
        ).reshape(-1, stride)
    # the others read the reconstructed row above, in order
    zero = np.zeros(stride, np.uint8)
    for y in np.flatnonzero(ftypes > 1):
        img[y] = _unfilter_row(int(ftypes[y]), img[y], img[y - 1] if y else zero, bpp)

    if depth == 16:
        img = img.view(">u2").astype(np.uint16)
    shape = (height, width) if ch == 1 else (height, width, ch)
    return img.reshape(shape)


def read_image(path: str, unchanged: bool = False) -> np.ndarray:
    """Read an image like disinfect_slam_tpu.io.png_io.read_image:
    unchanged=True keeps gray and 16-bit data as stored; otherwise the
    result is 8-bit RGB [H, W, 3]."""
    img = read_png(path)
    if unchanged:
        return img
    if img.dtype != np.uint8:
        raise ValueError(f"{path}: 16-bit image needs unchanged=True")
    if img.ndim == 2:
        img = np.repeat(img[..., None], 3, axis=-1)
    return img
