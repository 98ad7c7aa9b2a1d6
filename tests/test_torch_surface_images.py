"""Image files through the port against impact_tpu (PIL) on the CPU.

* ``load_image`` equals the reference's (``np.array_equal``, dtype and
  shape included) at every ``mode`` in (None, RGB, RGBA, L) for every PNG
  kind: grey at 1, 2, 4, 8 and 16 bits, RGB and RGBA at 8 and 16, palette at
  1, 2, 4 and 8 (short palettes, simple and per-entry tRNS), grey with alpha
  at 8 and 16, with and without tRNS keys, interlaced or not, at odd sizes,
  with rows in all five filters; and for every JPEG kind PIL writes here:
  baseline and progressive, 4:4:4, 4:2:2 and 4:2:0, greyscale, restart
  markers every block or every row, optimized tables, RGB with an Adobe
  marker, odd widths and heights.
* ``save_jpeg`` writes the bytes PIL writes (so PIL decodes both alike,
  with equal quantization tables).
* ``read_image_metadata`` gives the reference's result, or raises where it
  raises.
* ``load_image_layer`` is within 1e-6 of the reference's (1e-5 where it
  resizes, the Lanczos bar of ``tests/test_torch_textures.py``), and a
  texture array from a PNG and a JPEG has its mips within 1e-6.
* The fixtures under ``tests/data/surface_images`` (which ``chip_smoke.py``
  decodes on the card, where there is no PIL) are what PIL writes today,
  and their ``.rgb.png`` beside them is PIL's decode.

Run as a script from the repo root to write the fixtures:
``PYTHONPATH=. python tests/test_torch_surface_images.py``.
"""

import io
import pathlib
import struct
import warnings
import zlib

import numpy as np
import pytest
from PIL import Image

from impact_tpu.render import textures as jtex
from impact_tpu.utils import image as R
from impact_tpu_torch.render import textures as ttex
from impact_tpu_torch.utils import image as P
from impact_tpu_torch.utils import jpeg

FIXTURES = pathlib.Path(__file__).resolve().parent / "data" / "surface_images"
MODES = (None, "RGB", "RGBA", "L")
_ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4), (0, 2, 2, 4), (1, 0, 2, 2),
          (0, 1, 1, 2))


def _pack(samples, depth):
    h = samples.shape[0]
    if depth == 16:
        return samples.astype(">u2").reshape(h, -1).view(np.uint8)
    if depth == 8:
        return samples.astype(np.uint8).reshape(h, -1)
    flat = samples.reshape(h, -1).astype(np.uint8)
    bits = (flat[..., None] >> np.arange(depth - 1, -1, -1, dtype=np.uint8)) & 1
    return np.packbits(bits.reshape(h, -1), axis=1)


def _filter_rows(rows, bpp):
    """Rows u8 [h, stride] → filtered scanlines, row y in filter y % 5."""
    out, prev = [], np.zeros(rows.shape[1], np.int64)
    for y, cur in enumerate(rows.astype(np.int64)):
        a = np.concatenate([np.zeros(bpp, np.int64), cur])[:len(cur)]
        c = np.concatenate([np.zeros(bpp, np.int64), prev])[:len(cur)]
        kind = y % 5
        if kind == 0:
            f = cur
        elif kind == 1:
            f = cur - a
        elif kind == 2:
            f = cur - prev
        elif kind == 3:
            f = cur - ((a + prev) >> 1)
        else:
            p = a + prev - c
            pa, pb, pc = abs(p - a), abs(p - prev), abs(p - c)
            f = cur - np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, prev, c))
        out.append(bytes([kind]) + (f & 0xFF).astype(np.uint8).tobytes())
        prev = cur
    return b"".join(out)


def encode_png(samples, color, depth, palette=None, trns=None, interlace=0):
    """A PNG of any kind (samples [H,W,ch] of the raw values)."""
    h, w, ch = samples.shape
    bpp = max(1, ch * depth // 8)
    passes = _ADAM7 if interlace else ((0, 0, 1, 1),)
    raw = b"".join(_filter_rows(_pack(samples[y0::dy, x0::dx], depth), bpp)
                   for x0, y0, dx, dy in passes if samples[y0::dy, x0::dx].size)

    def chunk(kind, body):
        return (struct.pack(">I", len(body)) + kind + body
                + struct.pack(">I", zlib.crc32(kind + body) & 0xFFFFFFFF))

    out = b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, color, 0,
                                                          0, interlace))
    if palette is not None:
        out += chunk(b"PLTE", np.asarray(palette, np.uint8).tobytes())
    if trns is not None:
        out += chunk(b"tRNS", trns)
    return out + chunk(b"IDAT", zlib.compress(raw)) + chunk(b"IEND", b"")


def png_cases(color, depth, seed):
    """(label, PNG bytes) of one kind: sizes, interlacing and tRNS keys."""
    rng = np.random.default_rng(seed)
    ch = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}[color]
    for h, w in ((7, 5), (16, 13), (1, 1), (9, 33)):
        for interlace in (0, 1):
            s = rng.integers(0, 1 << depth, (h, w, ch))
            if depth == 16 and color == 0:  # grey values on both sides of the 8-bit clip
                s[0, 0, 0], s[-1, -1, 0] = 200, 40000
            palette, keys = None, [None]
            if color == 3:
                n = int(rng.integers(1, (1 << depth) + 1))
                palette = rng.integers(0, 256, (n, 3))
                keys = [None, bytes([255] * min(n, 3) + [0]), bytes(rng.integers(0, 256, n).tolist())]
            elif color == 0:
                keys = [None, struct.pack(">H", int(s[0, 0, 0]))]
            elif color == 2:
                keys = [None, struct.pack(">HHH", *(int(v) for v in s[0, 0]))]
            for k, trns in enumerate(keys):
                yield (f"{h}x{w}-i{interlace}-t{k}",
                       encode_png(s, color, depth, palette, trns, interlace))


def _outcome(fn):
    try:
        return fn(), None
    except Exception as e:  # noqa: BLE001  (both packages must raise alike)
        return None, e


def _hold_load(data, label):
    for mode in MODES:
        ref, ref_err = _outcome(lambda: R.load_image(data, mode))
        got, got_err = _outcome(lambda: P.load_image(data, mode))
        assert (ref_err is None) == (got_err is None), (label, mode, ref_err, got_err)
        if ref_err is None:
            assert got.dtype == ref.dtype and got.shape == ref.shape, (label, mode)
            assert np.array_equal(got, ref), (label, mode)


def _hold_metadata(data, label):
    ref, ref_err = _outcome(lambda: R.read_image_metadata(io.BytesIO(data)))
    got, got_err = _outcome(lambda: P.read_image_metadata(data))
    assert (ref_err is None) == (got_err is None), (label, ref_err, got_err)
    if ref_err is None:
        assert tuple(got) == tuple(ref), label
    elif isinstance(ref_err, ValueError):
        assert isinstance(got_err, ValueError), label


PNG_KINDS = [(0, 1), (0, 2), (0, 4), (0, 8), (0, 16), (2, 8), (2, 16), (3, 1), (3, 2), (3, 4),
             (3, 8), (4, 8), (4, 16), (6, 8), (6, 16)]


@pytest.mark.parametrize("color, depth", PNG_KINDS,
                         ids=[f"type{c}-{d}bit" for c, d in PNG_KINDS])
def test_png_kind_loads_as_the_reference(color, depth):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # PIL warns on palette transparency in bytes
        for label, data in png_cases(color, depth, seed=color * 100 + depth):
            _hold_load(data, label)
            _hold_metadata(data, label)


def _source(h, w, seed=0):
    """A smooth colour image with a checker and a little seeded noise."""
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:h, 0:w].astype(np.float64)
    y, x = y / max(h, 1), x / max(w, 1)
    chk = ((np.floor(x * 8) + np.floor(y * 8)) % 2) * 30 - 15
    img = np.stack([128 + 100 * np.sin(6.3 * x + 1.3 * y) + chk,
                    128 + 90 * np.cos(4.1 * y - 2.0 * x * x) - chk,
                    128 + 80 * np.sin(9.0 * x * y + 0.5) + 0.5 * chk], -1)
    return np.clip(np.round(img + rng.normal(0, 6.0, img.shape)), 0, 255).astype(np.uint8)


JPEG_KINDS = {
    "baseline-420": dict(),
    "baseline-422": dict(subsampling=1),
    "baseline-444": dict(subsampling=0),
    "progressive-420": dict(progressive=True),
    "progressive-444": dict(progressive=True, subsampling=0),
    "restart-every-block": dict(restart_marker_blocks=1),
    "progressive-restart-rows": dict(progressive=True, restart_marker_rows=1),
    "quality-50": dict(quality=50),
    "quality-100-422": dict(quality=100, subsampling=1),
    "optimized-tables": dict(optimize=True),
    "rgb-adobe": dict(keep_rgb=True),
}


def _pil_jpeg(img, **kw):
    buf = io.BytesIO()
    kw.setdefault("quality", 92)
    Image.fromarray(img).save(buf, format="JPEG", **kw)
    return buf.getvalue()


@pytest.mark.parametrize("kind", list(JPEG_KINDS))
@pytest.mark.parametrize("grey", [False, True], ids=["colour", "grey"])
def test_jpeg_kind_loads_as_the_reference(kind, grey):
    for h, w in ((8, 8), (17, 13), (37, 50), (1, 1), (3, 30)):
        img = _source(h, w, seed=h * 100 + w)
        data = _pil_jpeg(img[..., 0] if grey else img, **JPEG_KINDS[kind])
        _hold_load(data, f"{kind} {h}x{w}")
        _hold_metadata(data, f"{kind} {h}x{w}")


@pytest.mark.parametrize("shape", [(64, 48, 3), (17, 13, 3), (33, 47, 4), (21, 9)],
                         ids=["rgb", "odd", "rgba", "grey"])
def test_save_jpeg_writes_what_pil_writes(shape, tmp_path):
    rng = np.random.default_rng(3)
    img = np.clip(_source(shape[0], shape[1])[..., :1 if len(shape) == 2 else 3]
                  .astype(np.int64) + rng.integers(-9, 9, (shape[0], shape[1], 1)), 0, 255)
    img = img.astype(np.uint8)
    if len(shape) == 2:
        img = img[..., 0]
    elif shape[-1] == 4:
        img = np.concatenate([img, rng.integers(0, 256, shape[:2] + (1,), np.uint8)], -1)
    R.save_jpeg(tmp_path / "ref.jpg", img)
    P.save_jpeg(tmp_path / "port.jpg", img)
    ref, got = Image.open(tmp_path / "ref.jpg"), Image.open(tmp_path / "port.jpg")
    assert got.quantization == ref.quantization
    assert np.array_equal(np.asarray(got), np.asarray(ref))
    assert (tmp_path / "port.jpg").read_bytes() == (tmp_path / "ref.jpg").read_bytes()
    # the reference's test: a gradient round trip through both formats
    assert np.array_equal(P.load_image(tmp_path / "port.jpg"), R.load_image(tmp_path / "ref.jpg"))


def test_metadata_and_errors_of_other_files(tmp_path):
    for data in (b"not an image at all", b"\x89PNG\r\n\x1a\n", b"\xff\xd8\xff\xd9"):
        _hold_metadata(data, repr(data[:8]))
        ref, ref_err = _outcome(lambda: R.load_image(data))
        got, got_err = _outcome(lambda: P.load_image(data))
        assert ref_err is not None and got_err is not None
    # a four-component JPEG: the reference reads its header, the port's
    # decoder refuses it by name
    buf = io.BytesIO()
    Image.fromarray(_source(16, 16)).convert("CMYK").save(buf, format="JPEG")
    _hold_metadata(buf.getvalue(), "cmyk")
    with pytest.raises(ValueError, match="CMYK"):
        P.load_image(buf.getvalue())


def test_progressive_jpeg_cut_short_is_refused_where_libjpeg_smooths():
    """A progressive file that ends after its first scans: PIL reads it
    with libjpeg's block smoothing, the port refuses it by name (a
    difference in ``ROADMAP.md`` Queue 3)."""
    data = _pil_jpeg(_source(40, 48), progressive=True)
    scans = [i for i in range(len(data) - 1) if data[i:i + 2] == b"\xff\xda"]
    cut = data[:scans[2]] + b"\xff\xd9"  # the DC scan and one AC scan
    assert np.asarray(Image.open(io.BytesIO(cut)).convert("RGB")).shape == (40, 48, 3)
    with pytest.raises(ValueError, match="block smoothing"):
        P.load_image(cut)


def _write_kinds(tmp_path):
    img = _source(24, 20, seed=5)
    paths = {}
    for name, kw in (("base.jpg", {}), ("prog.jpg", dict(progressive=True, subsampling=0))):
        paths[name] = tmp_path / name
        paths[name].write_bytes(_pil_jpeg(img, **kw))
    for name, (s, color, depth) in {
            "grey2.png": (img[..., :1] >> 6, 0, 2), "rgb16.png": (img.astype(np.uint16) * 257, 2, 16),
            "palette.png": (img[..., :1] % 7, 3, 4), "la.png": (img[..., :2], 4, 8)}.items():
        palette = np.arange(21).reshape(7, 3) * 12 if color == 3 else None
        paths[name] = tmp_path / name
        paths[name].write_bytes(encode_png(s, color, depth, palette, interlace=1))
    return paths


def test_image_layers_and_texture_arrays_match_the_reference(tmp_path):
    paths = _write_kinds(tmp_path)
    for name, path in paths.items():
        for res, tol in ((None, 1e-6), (16, 1e-5)):
            ref = jtex.load_image_layer(str(path), resolution=res)
            got = ttex.load_image_layer(str(path), resolution=res)
            np.testing.assert_allclose(got, ref, atol=tol, rtol=0, err_msg=name)
    got = ttex.texture_array_from_images([str(paths["grey2.png"]), str(paths["base.jpg"])],
                                         resolution=16, device="cpu")
    ref = jtex.texture_array_from_images([str(paths["grey2.png"]), str(paths["base.jpg"])],
                                         resolution=16)
    assert got.n_layers == ref.n_layers == 2 and len(got.mips) == len(ref.mips)
    for a, b in zip(got.mips, ref.mips):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-6, rtol=0)


def fixture_images():
    """The card's fixtures by file name, made with PIL: a baseline 4:2:0
    and a progressive 4:4:4 JPEG at 256², an 8-bit greyscale PNG and a
    16-bit greyscale PNG (which PIL opens as I;16 and clips to RGB)."""
    n = 256
    y, x = np.mgrid[0:n, 0:n].astype(np.float64) / n
    chk = ((np.floor(x * 8) + np.floor(y * 8)) % 2) * 30 - 15
    img = np.stack([128 + 100 * np.sin(6.3 * x + 1.3 * y) + chk,
                    128 + 90 * np.cos(4.1 * y - 2.0 * x * x) - chk,
                    128 + 80 * np.sin(9.0 * x * y + 0.5) + 0.5 * chk], -1)
    img = np.clip(np.round(img), 0, 255).astype(np.uint8)
    grey16 = (np.linspace(0, 511, n)[None, :] + np.linspace(0, 200, n)[:, None]).astype(np.uint16)
    out = {}
    for name, im, kw in (("base420.jpg", img, dict(format="JPEG", quality=92)),
                         ("prog444.jpg", img, dict(format="JPEG", quality=92, progressive=True,
                                                   subsampling=0)),
                         ("grey8.png", img[..., 1], dict(format="PNG", optimize=True)),
                         ("grey16.png", grey16, dict(format="PNG"))):
        buf = io.BytesIO()
        Image.fromarray(im).save(buf, **kw)
        out[name] = buf.getvalue()
    return out


def write_fixtures(directory=FIXTURES):
    directory.mkdir(parents=True, exist_ok=True)
    for name, data in fixture_images().items():
        (directory / name).write_bytes(data)
        Image.open(io.BytesIO(data)).convert("RGB").save(directory / f"{name}.rgb.png",
                                                         optimize=True)


@pytest.mark.parametrize("name", ["base420.jpg", "prog444.jpg", "grey8.png", "grey16.png"])
def test_fixtures_are_what_pil_writes_and_decodes(name):
    data = (FIXTURES / name).read_bytes()
    assert data == fixture_images()[name]
    decoded = np.asarray(Image.open(FIXTURES / f"{name}.rgb.png"))
    assert decoded.dtype == np.uint8 and decoded.shape == (256, 256, 3)
    assert np.array_equal(np.asarray(Image.open(io.BytesIO(data)).convert("RGB")), decoded)
    assert np.array_equal(P.load_image(data, mode="RGB"), decoded)
    assert np.array_equal(P.load_image(FIXTURES / f"{name}.rgb.png"), decoded)


def test_jpeg_steps_hold_libjpeg_constants():
    """The fixed-point tables the codec's steps use are libjpeg's."""
    assert jpeg.round_fix(1.40200) == 91881 and jpeg.round_fix(0.34414) == 22554
    luma, chroma = jpeg.quality_tables(92)
    assert luma[0] == 3 and chroma[-1] == 16
    assert jpeg.ZIGZAG[:10].tolist() == [0, 1, 8, 16, 9, 2, 3, 10, 17, 24]


if __name__ == "__main__":
    write_fixtures()
