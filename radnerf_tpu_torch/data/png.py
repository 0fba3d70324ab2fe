"""A small PNG codec in numpy and the standard library's zlib.

`read_png` decodes 8-bit grayscale, RGB and RGBA images, non-interlaced,
with any of the five row filters, into the uint8 array imageio returns:
(H, W) for grayscale, (H, W, 3) or (H, W, 4) otherwise. `write_png`
writes 8-bit grayscale or RGB. Other PNGs (palette, 16-bit, interlaced)
raise ValueError.

The image loaders use it only where imageio is missing (see
color_utils.imread); the native decoder (data/native.py) comes first.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

SIGNATURE = b"\x89PNG\r\n\x1a\n"
_CHANNELS = {0: 1, 2: 3, 6: 4}          # PNG colour type -> channels


def _chunks(data: bytes):
    pos = len(SIGNATURE)
    while pos < len(data):
        if pos + 8 > len(data):
            raise ValueError("truncated PNG chunk header")
        (length,) = struct.unpack(">I", data[pos:pos + 4])
        kind = data[pos + 4:pos + 8]
        body = data[pos + 8:pos + 8 + length]
        crc = data[pos + 8 + length:pos + 12 + length]
        if len(body) != length or len(crc) != 4:
            raise ValueError(f"truncated PNG chunk {kind!r}")
        if zlib.crc32(kind + body) != struct.unpack(">I", crc)[0]:
            raise ValueError(f"PNG chunk {kind!r} fails its CRC")
        yield kind, body
        pos += 12 + length


def _unfilter(raw: np.ndarray, bpp: int) -> np.ndarray:
    """Undo the per-row filters of (H, 1 + stride) filtered bytes."""
    h, stride = raw.shape[0], raw.shape[1] - 1
    out = np.zeros((h, stride), np.uint8)
    prev = np.zeros(stride, np.uint8)
    for y in range(h):
        kind, cur = raw[y, 0], raw[y, 1:]
        if kind == 0:                                    # None
            row = cur
        elif kind == 1:                                  # Sub
            row = np.cumsum(cur.reshape(-1, bpp), axis=0,
                            dtype=np.uint8).reshape(-1)
        elif kind == 2:                                  # Up
            row = cur + prev
        elif kind in (3, 4):                             # Average, Paeth
            row = bytearray(cur.tobytes())
            up = prev.tobytes()
            for i in range(stride):
                a = row[i - bpp] if i >= bpp else 0
                b = up[i]
                if kind == 3:
                    pred = (a + b) >> 1
                else:
                    c = up[i - bpp] if i >= bpp else 0
                    p = a + b - c
                    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
                    pred = a if pa <= pb and pa <= pc else (
                        b if pb <= pc else c)
                row[i] = (row[i] + pred) & 0xFF
            row = np.frombuffer(bytes(row), np.uint8)
        else:
            raise ValueError(f"unknown PNG filter type {kind}")
        out[y] = row
        prev = out[y]
    return out


def decode_png(data: bytes) -> np.ndarray:
    """PNG bytes -> uint8 (H, W) or (H, W, C)."""
    if data[:len(SIGNATURE)] != SIGNATURE:
        raise ValueError("not a PNG file")
    header, idat = None, []
    for kind, body in _chunks(data):
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
    if header is None:
        raise ValueError("PNG without IHDR")
    w, h, depth, colour, _, _, interlace = header
    if depth != 8 or colour not in _CHANNELS or interlace:
        raise ValueError(
            f"PNG of bit depth {depth}, colour type {colour}, interlace "
            f"{interlace}: only 8-bit gray, RGB and RGBA without interlace "
            "are supported")
    c = _CHANNELS[colour]
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    if raw.size != h * (1 + w * c):
        raise ValueError("PNG image data has the wrong size")
    img = _unfilter(raw.reshape(h, 1 + w * c), c)
    return img.reshape(h, w) if c == 1 else img.reshape(h, w, c)


def png_size(data: bytes) -> tuple[int, int]:
    """(width, height) from the IHDR chunk of PNG bytes."""
    if data[:len(SIGNATURE)] != SIGNATURE or data[12:16] != b"IHDR":
        raise ValueError("not a PNG file")
    return struct.unpack(">II", data[16:24])


def read_png(path: str) -> np.ndarray:
    with open(path, "rb") as f:
        return decode_png(f.read())


def _chunk(kind: bytes, body: bytes) -> bytes:
    return (struct.pack(">I", len(body)) + kind + body
            + struct.pack(">I", zlib.crc32(kind + body)))


def encode_png(img: np.ndarray) -> bytes:
    """uint8 (H, W) gray or (H, W, 3) RGB -> PNG bytes (no row filter)."""
    img = np.ascontiguousarray(img)
    if img.dtype != np.uint8:
        raise ValueError(f"PNG writer takes uint8, not {img.dtype}")
    if img.ndim == 2:
        colour = 0
    elif img.ndim == 3 and img.shape[2] == 3:
        colour = 2
    else:
        raise ValueError(f"PNG writer takes (H, W) or (H, W, 3), not "
                         f"{img.shape}")
    h, w = img.shape[:2]
    rows = np.concatenate([np.zeros((h, 1), np.uint8), img.reshape(h, -1)],
                          axis=1)
    return (SIGNATURE
            + _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, colour, 0, 0,
                                          0))
            + _chunk(b"IDAT", zlib.compress(rows.tobytes(), 6))
            + _chunk(b"IEND", b""))


def write_png(path: str, img: np.ndarray) -> None:
    with open(path, "wb") as f:
        f.write(encode_png(img))
