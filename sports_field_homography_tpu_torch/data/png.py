"""A small PNG reader and writer on the standard library's zlib and numpy.

Reads 8-bit, non-interlaced grayscale (L), gray+alpha, RGB and RGBA PNGs:
enough for the court templates and for frames, where Pillow is absent.
Pillow is used instead wherever it is installed.  Encodes 8-bit L and RGB
PNGs with filter 0 and zlib level 1 (synthetic frames, the predict CLI's
masks).

PNG filters predict each byte from its left, upper and upper-left
neighbours (Sub, Up, Average, Paeth), so a row cannot be undone in one
vectorised step.  Every one of those neighbours lies on an earlier
anti-diagonal (row + column) of the pixel grid, though, so the image is
unfiltered one anti-diagonal at a time: H + W - 1 numpy steps, each over
all the pixels of its diagonal, whatever filter each row uses.  An image
whose rows all use filter 0 (None) needs no unfiltering and skips that loop.
"""
from __future__ import annotations

import struct
import zlib

import numpy as np

__all__ = ["read_png", "decode_png", "write_png", "encode_png"]

_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_CHANNELS = {0: 1, 2: 3, 4: 2, 6: 4}       # PNG colour type -> channels


def _unfilter(ftype: np.ndarray, raw: np.ndarray) -> np.ndarray:
    """ftype (H,) filter bytes; raw (H, W, C) filtered bytes -> (H, W, C)."""
    h, w, c = raw.shape
    if ftype.max(initial=0) > 4:
        raise ValueError(f"bad PNG filter type {int(ftype.max())}")
    # one zero row above and one zero column left: the PNG border rule
    out = np.zeros((h + 1, w + 1, c), np.int32)
    raw = raw.astype(np.int32)
    for d in range(h + w - 1):
        r = np.arange(max(0, d - w + 1), min(h - 1, d) + 1)
        x = d - r
        a = out[r + 1, x]          # left
        b = out[r, x + 1]          # up
        cc = out[r, x]             # up-left
        p = a + b - cc
        pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - cc)
        paeth = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, cc))
        t = ftype[r][:, None]
        pred = np.where(t == 1, a, np.where(t == 2, b, np.where(
            t == 3, (a + b) >> 1, np.where(t == 4, paeth, 0))))
        out[r + 1, x + 1] = (raw[r, x] + pred) & 0xFF
    return out[1:, 1:].astype(np.uint8)


def read_png(path: str) -> np.ndarray:
    """Decode a PNG file to (H, W) uint8 for grayscale, else (H, W, C)."""
    with open(path, "rb") as f:
        return decode_png(f.read(), path)


def decode_png(data: bytes, path: str = "<bytes>") -> np.ndarray:
    """Decode a PNG's bytes (``path`` names it in errors), as ``read_png``."""
    if data[:8] != _SIGNATURE:
        raise ValueError(f"{path}: not a PNG file")
    pos, header, idat = 8, None, []
    while pos + 8 <= len(data):
        length, ctype = struct.unpack(">I4s", data[pos:pos + 8])
        chunk = data[pos + 8:pos + 8 + length]
        pos += 12 + length
        if ctype == b"IHDR":
            header = struct.unpack(">IIBBBBB", chunk)
        elif ctype == b"IDAT":
            idat.append(chunk)
        elif ctype == b"IEND":
            break
    if header is None:
        raise ValueError(f"{path}: no IHDR chunk")
    w, h, depth, color, _, _, interlace = header
    if depth != 8 or color not in _CHANNELS or interlace != 0:
        raise ValueError(
            f"{path}: only 8-bit non-interlaced L/LA/RGB/RGBA PNGs are "
            f"supported (bit depth {depth}, colour type {color}, "
            f"interlace {interlace}); install Pillow for others")
    c = _CHANNELS[color]
    rows = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    rows = rows[:h * (w * c + 1)].reshape(h, w * c + 1)
    if rows[:, 0].any():
        img = _unfilter(rows[:, 0], rows[:, 1:].reshape(h, w, c))
    else:   # every row filter 0 (None), as encode_png writes: the bytes are the pixels
        img = np.array(rows[:, 1:].reshape(h, w, c))
    return img[..., 0] if c == 1 else img


def encode_png(img: np.ndarray) -> bytes:
    """(H, W) uint8 as an L PNG or (H, W, 3) uint8 as an RGB PNG, in that
    channel order, every row with filter 0; returns the file's bytes."""
    img = np.ascontiguousarray(img, dtype=np.uint8)
    if img.ndim == 2:
        color, c = 0, 1
    elif img.ndim == 3 and img.shape[2] == 3:
        color, c = 2, 3
    else:
        raise ValueError(f"encode_png takes (H, W) or (H, W, 3), got {img.shape}")
    h, w = img.shape[:2]
    raw = np.concatenate([np.zeros((h, 1), np.uint8), img.reshape(h, w * c)], 1)

    def chunk(kind, data):
        body = kind + data
        return struct.pack(">I", len(data)) + body + struct.pack(
            ">I", zlib.crc32(body) & 0xFFFFFFFF)

    return b"".join([
        _SIGNATURE,
        chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, color, 0, 0, 0)),
        chunk(b"IDAT", zlib.compress(raw.tobytes(), 1)),
        chunk(b"IEND", b"")])


def write_png(path: str, img: np.ndarray) -> None:
    """Write (H, W) uint8 as an L PNG or (H, W, 3) uint8 as an RGB PNG
    (``encode_png``)."""
    data = encode_png(img)
    with open(path, "wb") as f:
        f.write(data)
