"""PNG input and output, and image comparison (port of
``impact_tpu/utils/image.py``: ``load_png``, ``save_png`` and
``rgb_hybrid_compare``, per-channel global SSIM blended with mean RGB
proximity).

The reference reads and writes PNGs through PIL; the port decodes and
encodes them itself with ``zlib`` and numpy: 8-bit RGB and RGBA, not
interlaced, all five scanline filters."""

from __future__ import annotations

import struct
import zlib
from pathlib import Path

import numpy as np

_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_CHANNELS = {2: 3, 6: 4}  # PNG colour type → channels (RGB, RGBA)


def _chunks(data: bytes):
    pos = len(_SIGNATURE)
    while pos < len(data):
        (length,) = struct.unpack(">I", data[pos:pos + 4])
        kind = data[pos + 4:pos + 8]
        yield kind, data[pos + 8:pos + 8 + length]
        pos += 12 + length


def _unfilter(raw: np.ndarray, h: int, stride: int, bpp: int) -> np.ndarray:
    """Undo the per-row filters (None, Sub, Up, Average, Paeth) →
    u8 [h, stride]."""
    rows = raw.reshape(h, stride + 1)
    out = np.zeros((h, stride), np.uint8)
    prev = np.zeros(stride, np.int64)
    for y in range(h):
        kind, line = rows[y, 0], rows[y, 1:].astype(np.int64)
        if kind == 0:
            cur = line
        elif kind == 1:  # Sub: a running sum along the row, per channel
            cur = np.cumsum(line.reshape(-1, bpp), axis=0).reshape(-1) & 0xFF
        elif kind == 2:  # Up
            cur = (line + prev) & 0xFF
        elif kind in (3, 4):
            # Average and Paeth read the reconstructed byte bpp to the left:
            # one byte at a time
            cur_b, up, raw_b = [0] * stride, prev.tolist(), line.tolist()
            for x in range(stride):
                a = cur_b[x - bpp] if x >= bpp else 0
                b = up[x]
                if kind == 3:
                    pred = (a + b) >> 1
                else:
                    c = up[x - bpp] if x >= bpp else 0
                    p = a + b - c
                    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
                    pred = a if pa <= pb and pa <= pc else (b if pb <= pc else c)
                cur_b[x] = (raw_b[x] + pred) & 0xFF
            cur = np.asarray(cur_b, np.int64)
        else:
            raise ValueError(f"PNG row {y} has unknown filter type {kind}")
        out[y] = cur
        prev = cur
    return out


def load_png(path) -> np.ndarray:
    """An 8-bit RGB or RGBA PNG (a path or the file's bytes) → u8 [H,W,3]
    (alpha dropped, as the reference converts to RGB)."""
    if isinstance(path, (bytes, bytearray)):
        data, path = bytes(path), "PNG bytes"
    else:
        data = Path(path).read_bytes()
    if not data.startswith(_SIGNATURE):
        raise ValueError(f"{path} is not a PNG file")
    header, idat = None, []
    for kind, body in _chunks(data):
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
    w, h, depth, color, _, _, interlace = header
    if depth != 8 or color not in _CHANNELS or interlace != 0:
        raise ValueError(f"{path}: only 8-bit RGB/RGBA PNGs without interlacing are read "
                         f"(bit depth {depth}, colour type {color}, interlace {interlace})")
    ch = _CHANNELS[color]
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    img = _unfilter(raw, h, w * ch, ch).reshape(h, w, ch)
    return np.ascontiguousarray(img[..., :3])


def save_png(path, image_u8) -> None:
    """u8 [H,W,3] or [H,W,4] → an 8-bit RGB or RGBA PNG (no row filter)."""
    img = np.ascontiguousarray(np.asarray(image_u8, np.uint8))
    if img.ndim != 3 or img.shape[-1] not in (3, 4):
        raise ValueError(f"save_png takes u8 [H,W,3|4], got {img.shape}")
    h, w, ch = img.shape
    raw = np.concatenate([np.zeros((h, 1), np.uint8), img.reshape(h, w * ch)], axis=1)

    def chunk(kind, body):
        return (struct.pack(">I", len(body)) + kind + body
                + struct.pack(">I", zlib.crc32(kind + body) & 0xFFFFFFFF))

    header = struct.pack(">IIBBBBB", w, h, 8, 2 if ch == 3 else 6, 0, 0, 0)
    Path(path).write_bytes(_SIGNATURE + chunk(b"IHDR", header)
                           + chunk(b"IDAT", zlib.compress(raw.tobytes(), 6)) + chunk(b"IEND", b""))


def _ssim_gray(a, b):
    c1, c2 = 0.01 ** 2, 0.03 ** 2
    mu_a, mu_b = a.mean(), b.mean()
    va, vb = a.var(), b.var()
    cov = ((a - mu_a) * (b - mu_b)).mean()
    return ((2 * mu_a * mu_b + c1) * (2 * cov + c2)) / (
        (mu_a ** 2 + mu_b ** 2 + c1) * (va + vb + c2)
    )


def rgb_hybrid_compare(a_u8, b_u8) -> float:
    """Similarity score in [0,1]; 1 = identical."""
    a = np.asarray(a_u8, np.float32) / 255.0
    b = np.asarray(b_u8, np.float32) / 255.0
    if a.shape != b.shape:
        return 0.0
    ssim = float(np.mean([_ssim_gray(a[..., c], b[..., c]) for c in range(3)]))
    rms = float(np.sqrt(np.mean((a - b) ** 2)))
    return max(0.0, min(1.0, 0.5 * (ssim + (1.0 - rms))))
