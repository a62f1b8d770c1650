"""PNG reader and writer on the standard library's zlib and numpy.

The logged replays this package reads hold non-interlaced 8-bit RGB
(`*_rgb.png`) and 16-bit gray (`*_depth`, `*_ht`, `*_no_ht`) PNGs, and
the renders it writes are 8-bit RGBA; a host with neither OpenCV nor
Pillow must still read and write them.  Reading supports 8- and 16-bit
gray, RGB and RGBA, all five row filters (None and Sub rows are undone
for the whole image at once, Up row by row, Average and Paeth pixel by
pixel); interlaced, palette, gray-alpha and sub-byte files raise
ValueError.  Writing uses filter None on every row.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_CHANNELS = {0: 1, 2: 3, 6: 4}  # color type -> channels (gray, RGB, RGBA)
_COLOR_TYPE = {1: 0, 3: 2, 4: 6}


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
    """Decode a PNG: uint8 or uint16 [H, W] (gray) or [H, W, 3 or 4]
    (RGB, RGBA)."""
    with open(path, "rb") as f:
        header, payload = _parse(f.read())
    width, height, depth, color, _, _, interlace = header
    if interlace:
        raise ValueError(f"{path}: interlaced PNG is not supported")
    if depth not in (8, 16) or color not in _CHANNELS:
        raise ValueError(
            f"{path}: only 8/16-bit gray, RGB or RGBA PNGs are supported "
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
    unchanged=True keeps gray, alpha and 16-bit data as stored; otherwise
    the result is 8-bit RGB [H, W, 3]."""
    img = read_png(path)
    if unchanged:
        return img
    if img.dtype != np.uint8:
        raise ValueError(f"{path}: 16-bit image needs unchanged=True")
    if img.ndim == 2:
        img = np.repeat(img[..., None], 3, axis=-1)
    return img[..., :3]


def encode_png(img: np.ndarray) -> bytes:
    """Encode u8 gray [H, W], RGB or RGBA [H, W, 3|4], or u16 gray, to PNG
    bytes (zlib level 6, filter None; for u8 the bytes of the JAX
    package's stdlib encoder)."""
    img = np.ascontiguousarray(img)
    ch = 1 if img.ndim == 2 else img.shape[2]
    if img.ndim not in (2, 3) or ch not in _COLOR_TYPE:
        raise ValueError(f"unsupported image shape {img.shape}")
    if img.dtype == np.uint16 and ch == 1:
        depth, data = 16, img.astype(">u2")
    elif img.dtype == np.uint8:
        depth, data = 8, img
    else:
        raise ValueError(f"unsupported image type {img.dtype} with {ch} channels")
    h, w = img.shape[:2]
    rows = data.reshape(h, -1).view(np.uint8)
    raw = np.concatenate([np.zeros((h, 1), np.uint8), rows], axis=1).tobytes()

    def chunk(tag: bytes, body: bytes) -> bytes:
        return (struct.pack(">I", len(body)) + tag + body
                + struct.pack(">I", zlib.crc32(tag + body) & 0xFFFFFFFF))

    ihdr = struct.pack(">IIBBBBB", w, h, depth, _COLOR_TYPE[ch], 0, 0, 0)
    return (_SIGNATURE + chunk(b"IHDR", ihdr)
            + chunk(b"IDAT", zlib.compress(raw, 6)) + chunk(b"IEND", b""))


def write_image(path: str, img: np.ndarray) -> None:
    """Write an image as PNG; accepts what encode_png takes."""
    data = encode_png(np.asarray(img))
    with open(path, "wb") as f:
        f.write(data)
