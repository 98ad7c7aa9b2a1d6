"""Image input and output, and image comparison (port of
``impact_tpu/utils/image.py``: ``ImageMetadata``, ``read_image_metadata``,
``load_image``, ``save_png``, ``save_jpeg``, ``load_png`` and
``rgb_hybrid_compare``, per-channel global SSIM blended with mean RGB
proximity).

The reference reads and writes images through PIL; the port decodes and
encodes them itself, on the host, with ``zlib`` and numpy, and gives what
PIL gives. PNG: every colour type (grey, RGB, palette, grey with alpha,
RGBA) at every bit depth PNG allows (1, 2, 4, 8, 16), PLTE and tRNS, Adam7
interlacing and all five scanline filters, each opened in PIL's mode (``1``,
``L``, ``I;16``, ``RGB``, ``P``, ``LA``, ``RGBA``; 16-bit colour keeps the
high byte, 16-bit grey with alpha opens as RGBA) and converted as PIL
converts. JPEG: ``utils/jpeg.py``, the port's codec."""

from __future__ import annotations

import re
import struct
import zlib
from pathlib import Path
from typing import NamedTuple

import numpy as np

from . import jpeg

_SIGNATURE = b"\x89PNG\r\n\x1a\n"
# PNG colour type → samples per pixel
_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}
_DEPTHS = {0: (1, 2, 4, 8, 16), 2: (8, 16), 3: (1, 2, 4, 8), 4: (8, 16), 6: (8, 16)}
# (bit depth, colour type) → the mode PIL opens the PNG in
_PIL_MODES = {
    (1, 0): "1", (2, 0): "L", (4, 0): "L", (8, 0): "L", (16, 0): "I;16",
    (8, 2): "RGB", (16, 2): "RGB", (1, 3): "P", (2, 3): "P", (4, 3): "P", (8, 3): "P",
    (8, 4): "LA", (16, 4): "RGBA", (8, 6): "RGBA", (16, 6): "RGBA",
}
_ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4), (0, 2, 2, 4), (1, 0, 2, 2),
          (0, 1, 1, 2))
_SIMPLE_PALETTE = re.compile(b"^\xff*\x00\xff*$")


class ImageMetadata(NamedTuple):
    """Dimensions and pixel format of an image file, read from its header
    (ref: impact_io/src/image.rs:22 ImageMetadata / PixelFormat)."""

    width: int
    height: int
    pixel_format: str  # "rgba8" | "rgb8" | "luma8"


_FORMAT_OF_MODE = {"RGBA": "rgba8", "RGB": "rgb8", "L": "luma8"}


class UnidentifiedImageError(OSError, ValueError):
    """Bytes that are neither a PNG nor a JPEG (PIL raises an ``OSError``
    there; this one is also a ``ValueError``)."""


def _read(path_or_bytes) -> tuple[bytes, str]:
    if isinstance(path_or_bytes, (bytes, bytearray, memoryview)):
        return bytes(path_or_bytes), "image bytes"
    return Path(path_or_bytes).read_bytes(), str(path_or_bytes)


def _chunks(data: bytes):
    pos = len(_SIGNATURE)
    while pos + 8 <= len(data):
        (length,) = struct.unpack(">I", data[pos:pos + 4])
        kind = data[pos + 4:pos + 8]
        yield kind, data[pos + 8:pos + 8 + length]
        pos += 12 + length


def _png_header(data: bytes, name: str):
    for kind, body in _chunks(data):
        if kind == b"IHDR":
            w, h, depth, color, _, _, interlace = struct.unpack(">IIBBBBB", body[:13])
            if color not in _CHANNELS or depth not in _DEPTHS[color]:
                raise ValueError(f"{name}: PNG bit depth {depth} is not allowed with colour "
                                 f"type {color}")
            return w, h, depth, color, interlace
        break
    raise ValueError(f"{name}: PNG without an IHDR chunk")


def _unfilter(raw: np.ndarray, h: int, stride: int, bpp: int) -> np.ndarray:
    """Undo the per-row filters (None, Sub, Up, Average, Paeth) →
    u8 [h, stride]."""
    rows = raw[:h * (stride + 1)].reshape(h, stride + 1)
    out = np.zeros((h, stride), np.uint8)
    prev = np.zeros(stride, np.int64)
    for y in range(h):
        kind, line = rows[y, 0], rows[y, 1:].astype(np.int64)
        if kind == 0:
            cur = line
        elif kind == 1:  # Sub: a running sum along the row, per channel
            pad = (-stride) % bpp
            cur = (np.cumsum(np.pad(line, (0, pad)).reshape(-1, bpp), axis=0)
                   .reshape(-1)[:stride] & 0xFF)
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


def _samples(rows: np.ndarray, w: int, ch: int, depth: int) -> np.ndarray:
    """Unfiltered rows u8 [h, stride] → samples [h, w, ch] (u8, or u16 at
    depth 16)."""
    h = rows.shape[0]
    if depth == 16:
        return rows.reshape(h, -1).view(">u2")[:, :w * ch].astype(np.uint16).reshape(h, w, ch)
    if depth == 8:
        return rows[:, :w * ch].reshape(h, w, ch)
    bits = np.unpackbits(rows, axis=1)[:, :w * ch * depth].reshape(h, w * ch, depth)
    weights = (1 << np.arange(depth - 1, -1, -1)).astype(np.uint8)
    return (bits * weights).sum(axis=-1).astype(np.uint8).reshape(h, w, ch)


def _decode_png(data: bytes, name: str):
    """PNG bytes → (bit depth, colour type, samples [H,W,ch], palette
    [n,3] or None, tRNS bytes or None)."""
    w, h, depth, color, interlace = _png_header(data, name)
    idat, palette, trns = [], None, None
    for kind, body in _chunks(data):
        if kind == b"IDAT":
            idat.append(body)
        elif kind == b"PLTE":
            palette = np.frombuffer(body[:len(body) // 3 * 3], np.uint8).reshape(-1, 3)
        elif kind == b"tRNS":
            trns = body
        elif kind == b"IEND":
            break
    ch = _CHANNELS[color]
    bpp = max(1, ch * depth // 8)
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    dtype = np.uint16 if depth == 16 else np.uint8
    if interlace == 0:
        stride = -(-w * ch * depth // 8)
        img = _samples(_unfilter(raw, h, stride, bpp), w, ch, depth)
    else:
        img = np.zeros((h, w, ch), dtype)
        pos = 0
        for x0, y0, dx, dy in _ADAM7:
            pw, ph = -(-(w - x0) // dx) if w > x0 else 0, -(-(h - y0) // dy) if h > y0 else 0
            if pw == 0 or ph == 0:
                continue
            stride = -(-pw * ch * depth // 8)
            rows = _unfilter(raw[pos:pos + ph * (stride + 1)], ph, stride, bpp)
            pos += ph * (stride + 1)
            img[y0::dy, x0::dx] = _samples(rows, pw, ch, depth)
    if color == 3 and palette is None:
        raise ValueError(f"{name}: palette PNG without a PLTE chunk")
    return depth, color, img, palette, trns


def _pil_image(depth, color, img, palette, trns):
    """The samples as PIL holds the PNG: (mode, pixels, palette [256,3] or
    None, the ``transparency`` info or None)."""
    mode = _PIL_MODES[(depth, color)]
    hi = (img >> 8).astype(np.uint8) if depth == 16 else img
    transparency = None
    if mode == "1":
        px = (img[..., 0] * 255).astype(np.uint8)
    elif mode == "L" and color == 0:
        px = (img[..., 0] * (255 // ((1 << depth) - 1))).astype(np.uint8)
    elif mode == "I;16":
        px = img[..., 0]
    elif mode == "P":
        px = img[..., 0]
    elif color == 4 and depth == 16:
        px = np.concatenate([hi[..., :1]] * 3 + [hi[..., 1:]], axis=-1)
    else:
        px = hi
    full = None
    if mode == "P":
        full = np.zeros((256, 3), np.uint8)
        full[:len(palette)] = palette[:256]
    if trns is not None:
        if mode == "P":
            if _SIMPLE_PALETTE.match(trns):
                i = trns.find(b"\0")
                transparency = i if i >= 0 else None
            else:
                transparency = trns
        elif mode in ("1", "L", "I;16") and len(trns) >= 2:
            transparency = struct.unpack(">H", trns[:2])[0]
        elif mode == "RGB" and len(trns) >= 6:
            transparency = struct.unpack(">HHH", trns[:6])
    return mode, px, full, transparency


def _luma(rgb) -> np.ndarray:
    """PIL's RGB → L (ITU-R 601-2 luma in 16-bit fixed point, rounded)."""
    r, g, b = (rgb[..., i].astype(np.int64) for i in range(3))
    return ((r * 19595 + g * 38470 + b * 7471 + 0x8000) >> 16).astype(np.uint8)


def _convert(mode, px, palette, transparency, target):
    """PIL's ``Image.convert(target)`` of a decoded image, for the targets
    the reference asks for (RGB, RGBA, L)."""
    if target == mode:
        return px
    if mode == "P":
        rgb = palette[px]
        if target == "RGB":
            return rgb
        if target == "L":
            return _luma(rgb)
        alpha = np.full(256, 255, np.uint8)
        if isinstance(transparency, bytes):
            alpha[:len(transparency)] = np.frombuffer(transparency[:256], np.uint8)
        elif isinstance(transparency, int):
            alpha[transparency] = 0
        return np.concatenate([rgb, alpha[px][..., None]], axis=-1)
    if mode == "I;16":
        grey = np.minimum(px, 255).astype(np.uint8)
    elif mode in ("1", "L"):
        grey = px
    elif mode == "LA":
        grey = px[..., 0]
    else:
        grey = None
    if target == "L":
        return grey if grey is not None else _luma(px)
    rgb = np.repeat(grey[..., None], 3, axis=-1) if grey is not None else px[..., :3]
    if target == "RGB":
        return rgb
    if mode in ("RGBA", "LA"):
        return np.concatenate([rgb, px[..., -1:]], axis=-1)
    alpha = np.full(px.shape[:2], 255, np.uint8)
    if transparency is not None and mode in ("1", "L", "I;16"):
        # PIL keys the converted grey: a 1-bit key selects 0 or 255, a
        # 16-bit grey is clipped before the compare
        alpha[grey.astype(np.int64) == transparency * (255 if mode == "1" else 1)] = 0
    elif transparency is not None and mode == "RGB":
        alpha[np.all(px.astype(np.int64) == np.asarray(transparency), axis=-1)] = 0
    return np.concatenate([rgb, alpha[..., None]], axis=-1)


def read_image_metadata(path) -> ImageMetadata:
    """Width, height and pixel format from the file's header alone (ref:
    impact_io/src/image.rs:91 read_metadata_for_image_at_path). Files PIL
    would open in another mode than L, RGB or RGBA (palette, 1-bit or 16-bit
    grey, 8-bit grey with alpha, CMYK) raise ``ValueError`` as the
    reference's do."""
    data, name = _read(path)
    if data.startswith(_SIGNATURE):
        w, h, depth, color, _ = _png_header(data, name)
        mode = _PIL_MODES[(depth, color)]
    elif data.startswith(b"\xff\xd8"):
        w, h, nc = jpeg.read_header(data)
        mode = {1: "L", 3: "RGB", 4: "CMYK"}.get(nc, f"{nc} components")
    else:
        raise UnidentifiedImageError(f"cannot identify image file {name}")
    fmt = _FORMAT_OF_MODE.get(mode)
    if fmt is None:
        raise ValueError(f"unsupported pixel format (PIL mode {mode!r}) in {name}")
    return ImageMetadata(w, h, fmt)


def load_image(path_or_bytes, mode: str | None = None) -> np.ndarray:
    """Decode a PNG or JPEG (a path or the file's bytes) to a u8 array (ref:
    impact_io/src/image.rs:113/154 load_image_from_path / _from_bytes).
    ``mode`` "RGB", "RGBA" or "L" converts as PIL converts; None keeps L,
    RGB and RGBA and converts every other mode to RGB."""
    data, name = _read(path_or_bytes)
    if data.startswith(_SIGNATURE):
        pil_mode, px, palette, transparency = _pil_image(*_decode_png(data, name))
    elif data.startswith(b"\xff\xd8"):
        px = jpeg.decode(data)
        pil_mode, palette, transparency = ("L" if px.ndim == 2 else "RGB"), None, None
    else:
        raise UnidentifiedImageError(f"cannot identify image file {name}")
    if mode is None:
        mode = pil_mode if pil_mode in _FORMAT_OF_MODE else "RGB"
    if mode not in _FORMAT_OF_MODE:
        raise ValueError(f"load_image converts to RGB, RGBA or L, not {mode!r}")
    return np.ascontiguousarray(_convert(pil_mode, px, palette, transparency, mode))


def load_png(path) -> np.ndarray:
    """An image file (a path or its bytes) → u8 [H,W,3], converted to RGB
    as the reference's ``load_png`` converts it."""
    return load_image(path, mode="RGB")


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


def save_jpeg(path, image_u8, quality: int = 92) -> None:
    """u8 [H,W] or [H,W,3|4] → a baseline JPEG, the file PIL writes at
    ``quality`` (JPEG has no alpha: a fourth channel is dropped)."""
    Path(path).write_bytes(jpeg.encode(np.asarray(image_u8), quality))


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
