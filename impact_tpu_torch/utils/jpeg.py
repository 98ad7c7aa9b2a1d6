"""JPEG decoding and encoding on the host, in numpy (the port's own codec:
the reference reads and writes JPEG through PIL, ``impact_tpu/utils/image.py``
``load_image`` and ``save_jpeg``, and the card's machine has no PIL).

The decoder reads what PIL reads through libjpeg(-turbo) with its default
settings, to the byte: baseline and extended Huffman files (SOF0, SOF1) and
progressive ones (SOF2), 8-bit, one or three components, any sampling
factors up to 2×2, restart intervals, JFIF and Adobe markers. Its steps are
libjpeg's: the ISLOW integer inverse DCT (``jidctint.c``) with the range
limit's wrap, "fancy" triangle-filter upsampling (``jdsample.c``: h2v1, h1v2
and h2v2 with their rounding biases; replication elsewhere) and the
fixed-point YCbCr→RGB tables (``jdcolor.c``). Four-component (CMYK/YCCK),
arithmetic-coded, 12-bit, lossless and hierarchical files raise
``ValueError`` naming their kind, as does a progressive file whose low
coefficients never complete (libjpeg would smooth its blocks).

``encode`` writes what PIL's ``Image.save(format="JPEG", quality=q)`` writes:
baseline, 4:2:0 for colour (one component for greyscale), the Annex K
tables scaled by ``jpeg_quality_scaling``, the standard Huffman tables, the
fixed-point RGB→YCbCr tables (``jccolor.c``), h2v2 downsampling with its
1,2 bias (``jcsample.c``), the ISLOW forward DCT (``jfdctint.c``) and the
reciprocal quantizer of libjpeg-turbo (``jcdctmgr.c``).

Everything here runs once per image on the host; no frame or step reads
an image.
"""

from __future__ import annotations

import struct

import numpy as np


def _zigzag() -> np.ndarray:
    """Natural (row-major) index of each zigzag position."""
    out = []
    for s in range(15):
        cells = [(i, s - i) for i in range(8) if 0 <= s - i < 8]
        out += cells[::-1] if s % 2 == 0 else cells
    return np.array([i * 8 + j for i, j in out], np.int64)


ZIGZAG = _zigzag()
_ZZ = ZIGZAG.tolist()

_SOF_KINDS = {
    0xC3: "lossless (SOF3)", 0xC5: "hierarchical (SOF5)", 0xC6: "hierarchical progressive (SOF6)",
    0xC7: "hierarchical lossless (SOF7)", 0xC9: "arithmetic-coded (SOF9)",
    0xCA: "arithmetic-coded progressive (SOF10)", 0xCB: "arithmetic-coded lossless (SOF11)",
    0xCD: "arithmetic-coded hierarchical (SOF13)", 0xCE: "arithmetic-coded hierarchical (SOF14)",
    0xCF: "arithmetic-coded hierarchical lossless (SOF15)",
}

# libjpeg's fixed-point constants (CONST_BITS = 13)
_F0298, _F0390, _F0541, _F0765 = 2446, 3196, 4433, 6270
_F0899, _F1175, _F1501, _F1847 = 7373, 9633, 12299, 15137
_F1961, _F2053, _F2562, _F3072 = 16069, 16819, 20995, 25172


class _Frame:
    def __init__(self, kind, height, width, comps):
        self.kind, self.height, self.width, self.comps = kind, height, width, comps
        self.hmax = max(c["h"] for c in comps)
        self.vmax = max(c["v"] for c in comps)
        self.mcux = -(-width // (8 * self.hmax))
        self.mcuy = -(-height // (8 * self.vmax))
        for c in comps:
            c["dsw"] = -(-width * c["h"] // self.hmax)
            c["dsh"] = -(-height * c["v"] // self.vmax)
            c["bw"] = self.mcux * c["h"]
            c["bh"] = self.mcuy * c["v"]
            c["coef"] = [[0] * 64 for _ in range(c["bw"] * c["bh"])]
            c["bits"] = [-1] * 64  # successive-approximation state (coef_bits)
            c["qt"] = None


def _huffman_lookup(bits, vals):
    """16-bit peek tables: (code length, symbol) of every 16-bit prefix."""
    length = np.zeros(65536, np.int64)
    symbol = np.zeros(65536, np.int64)
    code, k = 0, 0
    for n in range(1, 17):
        for _ in range(bits[n - 1]):
            lo = code << (16 - n)
            length[lo:lo + (1 << (16 - n))] = n
            symbol[lo:lo + (1 << (16 - n))] = vals[k]
            code += 1
            k += 1
        code <<= 1
    return length.tolist(), symbol.tolist()


def _scan_segments(data: bytes, pos: int):
    """The entropy-coded data of one scan from ``pos``: its restart
    segments (byte stuffing removed, zero-padded as libjpeg pads past a
    marker) and the position of the marker that ends the scan."""
    segs, start, i, n = [], pos, pos, len(data)
    while True:
        j = data.find(b"\xff", i)
        if j < 0 or j + 1 >= n:
            segs.append(data[start:])
            end = n
            break
        k = j
        while k + 1 < n and data[k + 1] == 0xFF:
            k += 1
        m = data[k + 1] if k + 1 < n else 0xD9
        if m == 0 and k == j:
            i = j + 2
            continue
        if 0xD0 <= m <= 0xD7:
            segs.append(data[start:j])
            start = i = k + 2
            continue
        segs.append(data[start:j])
        end = k
        break
    return [s.replace(b"\xff\x00", b"\xff") + bytes(8) for s in segs], end


class _Bits:
    """MSB-first bit reader over one restart segment."""

    __slots__ = ("buf", "pos")

    def __init__(self, buf):
        self.buf, self.pos = buf, 0

    def peek16(self):
        b, p = self.buf, self.pos
        i = p >> 3
        if i + 2 >= len(b):
            return 0
        return ((b[i] << 16 | b[i + 1] << 8 | b[i + 2]) >> (8 - (p & 7))) & 0xFFFF

    def get(self, n):
        if n == 0:
            return 0
        v = self.peek16() >> (16 - n)
        self.pos += n
        return v

    def huff(self, table):
        length, symbol = table
        v = self.peek16()
        n = length[v]
        if n == 0:
            raise ValueError("corrupt JPEG data: bad Huffman code")
        self.pos += n
        return symbol[v]


def _extend(v, s):
    return v - (1 << s) + 1 if s and v < (1 << (s - 1)) else v


def _scan_blocks(frame, comps):
    """The blocks of a scan in coding order, grouped per MCU: a list of
    (component, block index) lists."""
    if len(comps) == 1:
        c = comps[0]
        nbx, nby = -(-c["dsw"] // 8), -(-c["dsh"] // 8)
        return [[(c, by * c["bw"] + bx)] for by in range(nby) for bx in range(nbx)]
    mcus = []
    for my in range(frame.mcuy):
        for mx in range(frame.mcux):
            blocks = []
            for c in comps:
                for vi in range(c["v"]):
                    for hi in range(c["h"]):
                        blocks.append((c, (my * c["v"] + vi) * c["bw"] + mx * c["h"] + hi))
            mcus.append(blocks)
    return mcus


def _decode_scan(frame, comps, ss, se, ah, al, segs, restart, progressive):
    mcus = _scan_blocks(frame, comps)
    per_seg = restart if restart else len(mcus)
    if progressive:
        for c in comps:
            for k in range(ss, se + 1):
                c["bits"][k] = al
    for si in range(0, len(mcus), per_seg):
        seg = segs[si // per_seg] if si // per_seg < len(segs) else bytes(8)
        rd = _Bits(seg)
        pred = {id(c): 0 for c in comps}
        eobrun = 0
        for mcu in mcus[si:si + per_seg]:
            for c, b in mcu:
                blk = c["coef"][b]
                if not progressive:
                    s = rd.huff(c["dc"])
                    pred[id(c)] += _extend(rd.get(s), s)
                    blk[0] = pred[id(c)]
                    k = 1
                    ac = c["ac"]
                    while k < 64:
                        rs = rd.huff(ac)
                        r, s = rs >> 4, rs & 15
                        if s:
                            k += r
                            blk[_ZZ[k]] = _extend(rd.get(s), s)
                            k += 1
                        elif r == 15:
                            k += 16
                        else:
                            break
                elif ss == 0:  # DC scans
                    if ah == 0:
                        s = rd.huff(c["dc"])
                        pred[id(c)] += _extend(rd.get(s), s)
                        blk[0] = pred[id(c)] * (1 << al)
                    elif rd.get(1):
                        blk[0] |= 1 << al
                elif ah == 0:  # AC first scan
                    if eobrun:
                        eobrun -= 1
                        continue
                    k = ss
                    ac = c["ac"]
                    while k <= se:
                        rs = rd.huff(ac)
                        r, s = rs >> 4, rs & 15
                        if s:
                            k += r
                            blk[_ZZ[k]] = _extend(rd.get(s), s) * (1 << al)
                        elif r == 15:
                            k += 15
                        else:
                            eobrun = (1 << r) + rd.get(r) - 1
                            break
                        k += 1
                else:  # AC refinement
                    p1, m1 = 1 << al, -1 << al
                    k = ss
                    if eobrun == 0:
                        ac = c["ac"]
                        while k <= se:
                            rs = rd.huff(ac)
                            r, s = rs >> 4, rs & 15
                            if s:
                                s = p1 if rd.get(1) else m1
                            elif r != 15:
                                eobrun = (1 << r) + rd.get(r)
                                break
                            while k <= se:
                                z = _ZZ[k]
                                if blk[z]:
                                    if rd.get(1) and not blk[z] & p1:
                                        blk[z] += p1 if blk[z] >= 0 else m1
                                else:
                                    if r == 0:
                                        break
                                    r -= 1
                                k += 1
                            if s and k <= se:
                                blk[_ZZ[k]] = s
                            k += 1
                    if eobrun > 0:
                        while k <= se:
                            z = _ZZ[k]
                            if blk[z] and rd.get(1) and not blk[z] & p1:
                                blk[z] += p1 if blk[z] >= 0 else m1
                            k += 1
                        eobrun -= 1


def _descale(x, n):
    return (x + (1 << (n - 1))) >> n


def _idct_1d(c0, c1, c2, c3, c4, c5, c6, c7):
    """libjpeg's ISLOW butterfly on (dequantized) inputs: the even and odd
    parts before descaling, as the pairs (tmp10±tmp3, ...)."""
    z1 = (c2 + c6) * _F0541
    tmp2 = z1 - c6 * _F1847
    tmp3 = z1 + c2 * _F0765
    tmp0 = (c0 + c4) << 13
    tmp1 = (c0 - c4) << 13
    t10, t13, t11, t12 = tmp0 + tmp3, tmp0 - tmp3, tmp1 + tmp2, tmp1 - tmp2
    o0, o1, o2, o3 = c7, c5, c3, c1
    z1, z2, z3, z4 = o0 + o3, o1 + o2, o0 + o2, o1 + o3
    z5 = (z3 + z4) * _F1175
    o0, o1, o2, o3 = o0 * _F0298, o1 * _F2053, o2 * _F3072, o3 * _F1501
    z1, z2 = z1 * -_F0899, z2 * -_F2562
    z3, z4 = z3 * -_F1961 + z5, z4 * -_F0390 + z5
    o0 += z1 + z3
    o1 += z2 + z4
    o2 += z2 + z3
    o3 += z1 + z4
    return (t10 + o3, t11 + o2, t12 + o1, t13 + o0, t13 - o0, t12 - o1, t11 - o2, t10 - o3)


def idct_islow(coef, qt) -> np.ndarray:
    """int [...,8,8] coefficients (natural order) and their quantization
    table [8,8] → u8 [...,8,8] samples, as ``jpeg_idct_islow`` computes them
    (range limit included: the descaled value wraps mod 1024 before the
    clamp)."""
    x = coef.astype(np.int64) * np.asarray(qt, np.int64)
    cols = _idct_1d(*(x[..., r, :] for r in range(8)))
    ws = np.stack([_descale(v, 11) for v in cols], axis=-2)  # rows of the work array
    rows = _idct_1d(*(ws[..., :, c] for c in range(8)))
    out = np.stack([_descale(v, 18) for v in rows], axis=-1)
    wrapped = ((out + 512) & 1023) - 512
    return np.clip(wrapped + 128, 0, 255).astype(np.uint8)


def _upsample(plane, dsw, dsh, hx, vx):
    """libjpeg's upsampling of one component's samples (the first ``dsh``
    rows and ``dsw`` columns of ``plane``) by (hx, vx)."""
    p = plane[:dsh, :dsw].astype(np.int64)
    if hx == 1 and vx == 1:
        return p
    if hx == 2 and vx == 1 and dsw > 2:
        left = np.concatenate([p[:, :1], p[:, :-1]], axis=1)
        right = np.concatenate([p[:, 1:], p[:, -1:]], axis=1)
        out = np.empty((dsh, 2 * dsw), np.int64)
        out[:, 0::2] = (3 * p + left + 1) >> 2
        out[:, 1::2] = (3 * p + right + 2) >> 2
        out[:, 0] = p[:, 0]
        out[:, -1] = p[:, -1]
        return out
    up = np.concatenate([p[:1], p[:-1]], axis=0)
    down = np.concatenate([p[1:], p[-1:]], axis=0)
    if hx == 1 and vx == 2:
        out = np.empty((2 * dsh, dsw), np.int64)
        out[0::2] = (3 * p + up + 1) >> 2
        out[1::2] = (3 * p + down + 2) >> 2
        return out
    if hx == 2 and vx == 2 and dsw > 2:
        out = np.empty((2 * dsh, 2 * dsw), np.int64)
        for rows, near in ((slice(0, None, 2), up), (slice(1, None, 2), down)):
            cs = 3 * p + near  # column sums
            last = np.concatenate([cs[:, :1], cs[:, :-1]], axis=1)
            nxt = np.concatenate([cs[:, 1:], cs[:, -1:]], axis=1)
            even = (3 * cs + last + 8) >> 4
            odd = (3 * cs + nxt + 7) >> 4
            even[:, 0] = (4 * cs[:, 0] + 8) >> 4
            odd[:, -1] = (4 * cs[:, -1] + 7) >> 4
            out[rows, 0::2] = even
            out[rows, 1::2] = odd
        return out
    return np.repeat(np.repeat(p, vx, axis=0), hx, axis=1)


def _ycc_to_rgb(y, cb, cr) -> np.ndarray:
    """``jdcolor.c`` ycc_rgb_convert: the fixed-point tables (16 bits)."""
    x_cb, x_cr = cb - 128, cr - 128
    one_half = 1 << 15
    r = y + ((round_fix(1.40200) * x_cr + one_half) >> 16)
    g = y + ((-round_fix(0.34414) * x_cb + one_half - round_fix(0.71414) * x_cr) >> 16)
    b = y + ((round_fix(1.77200) * x_cb + one_half) >> 16)
    return np.clip(np.stack([r, g, b], axis=-1), 0, 255).astype(np.uint8)


def round_fix(x: float) -> int:
    """libjpeg's FIX(x) at 16 fraction bits."""
    return int(x * (1 << 16) + 0.5)


def _check_smoothing(frame):
    """libjpeg smooths the blocks of a progressive file whose components all
    have their DC coefficients but not all of the first nine AC ones fully
    refined (``jdcoefct.c`` smoothing_ok); the port does not smooth, so it
    refuses such a file."""
    for c in frame.comps:
        if c["bits"][0] < 0:
            return
    for c in frame.comps:
        if any(b != 0 for b in c["bits"][1:10]):
            raise ValueError("progressive JPEG with incomplete low-frequency coefficients "
                             "(libjpeg's block smoothing) is not read")


def read_header(data: bytes):
    """(width, height, n_components) of a JPEG from its frame header,
    without decoding; ``ValueError`` for a file that is not a JPEG or whose
    kind the decoder does not read."""
    if not data.startswith(b"\xff\xd8"):
        raise ValueError("not a JPEG file")
    pos = 2
    while pos + 4 <= len(data):
        if data[pos] != 0xFF:
            pos += 1
            continue
        m = data[pos + 1]
        if m == 0xFF:
            pos += 1
            continue
        if m in (0xD8, 0x01) or 0xD0 <= m <= 0xD7:
            pos += 2
            continue
        (length,) = struct.unpack(">H", data[pos + 2:pos + 4])
        if m in (0xC0, 0xC1, 0xC2) or m in _SOF_KINDS:
            prec, h, w, nc = struct.unpack(">BHHB", data[pos + 4:pos + 10])
            return w, h, nc
        pos += 2 + length
    raise ValueError("JPEG without a frame header")


def decode(data: bytes) -> np.ndarray:
    """A JPEG file's bytes → u8 [H,W] (one component) or [H,W,3] RGB, equal
    to PIL's decode."""
    if not data.startswith(b"\xff\xd8"):
        raise ValueError("not a JPEG file")
    qts, dc_tabs, ac_tabs = {}, {}, {}
    frame, restart = None, 0
    jfif, adobe = False, None
    pos = 2
    n = len(data)
    while pos < n:
        if data[pos] != 0xFF:
            pos += 1
            continue
        m = data[pos + 1] if pos + 1 < n else 0xD9
        if m == 0xFF:
            pos += 1
            continue
        if m == 0xD9:
            break
        if m in (0xD8, 0x01) or 0xD0 <= m <= 0xD7:
            pos += 2
            continue
        (length,) = struct.unpack(">H", data[pos + 2:pos + 4])
        seg = data[pos + 4:pos + 2 + length]
        pos += 2 + length
        if m == 0xE0 and seg[:5] == b"JFIF\x00":
            jfif = True
        elif m == 0xEE and seg[:5] == b"Adobe" and len(seg) >= 12:
            adobe = seg[11]
        elif m == 0xDB:
            p = 0
            while p < len(seg):
                pq, tq = seg[p] >> 4, seg[p] & 15
                if pq:
                    vals = struct.unpack(">64H", seg[p + 1:p + 129])
                    p += 129
                else:
                    vals = tuple(seg[p + 1:p + 65])
                    p += 65
                table = np.zeros(64, np.int64)
                table[ZIGZAG] = vals
                qts[tq] = table.reshape(8, 8)
        elif m == 0xC4:
            p = 0
            while p < len(seg):
                tc, th = seg[p] >> 4, seg[p] & 15
                bits = list(seg[p + 1:p + 17])
                vals = list(seg[p + 17:p + 17 + sum(bits)])
                p += 17 + sum(bits)
                (ac_tabs if tc else dc_tabs)[th] = _huffman_lookup(bits, vals)
        elif m == 0xDD:
            (restart,) = struct.unpack(">H", seg[:2])
        elif m in _SOF_KINDS:
            raise ValueError(f"{_SOF_KINDS[m]} JPEG is not read")
        elif m in (0xC0, 0xC1, 0xC2):
            prec, h, w, nc = struct.unpack(">BHHB", seg[:6])
            if prec != 8:
                raise ValueError(f"{prec}-bit JPEG is not read (8-bit samples only)")
            if nc == 4:
                raise ValueError("four-component (CMYK/YCCK) JPEG is not read")
            if nc not in (1, 3):
                raise ValueError(f"JPEG with {nc} components is not read")
            if h == 0:
                raise ValueError("JPEG with a DNL-defined height is not read")
            comps = []
            for i in range(nc):
                cid, hv, tq = seg[6 + 3 * i:9 + 3 * i]
                comps.append({"id": cid, "h": hv >> 4, "v": hv & 15, "tq": tq})
            frame = _Frame(m, h, w, comps)
            for c in comps:
                if not 1 <= c["h"] <= 2 or not 1 <= c["v"] <= 2:
                    raise ValueError("JPEG sampling factors above 2 are not read")
        elif m == 0xDA:
            if frame is None:
                raise ValueError("JPEG scan before its frame header")
            ns = seg[0]
            scomps = []
            for i in range(ns):
                cid, t = seg[1 + 2 * i:3 + 2 * i]
                c = next(c for c in frame.comps if c["id"] == cid)
                if frame.kind != 0xC2 or seg[1 + 2 * ns] == 0:
                    c["dc"] = dc_tabs.get(t >> 4)
                c["ac"] = ac_tabs.get(t & 15)
                if c["qt"] is None:  # libjpeg latches a table at its first scan
                    c["qt"] = qts[c["tq"]]
                scomps.append(c)
            ss, se, a = seg[1 + 2 * ns:4 + 2 * ns]
            segs, pos = _scan_segments(data, pos)
            _decode_scan(frame, scomps, ss, se, a >> 4, a & 15, segs, restart,
                         frame.kind == 0xC2)
    if frame is None:
        raise ValueError("JPEG without a frame header")
    if frame.kind == 0xC2:
        _check_smoothing(frame)
    planes = []
    for c in frame.comps:
        if c["qt"] is None:
            raise ValueError("JPEG component without a scan")
        coef = np.asarray(c["coef"], np.int64).reshape(c["bh"], c["bw"], 8, 8)
        px = idct_islow(coef, c["qt"]).transpose(0, 2, 1, 3).reshape(c["bh"] * 8, c["bw"] * 8)
        hx, vx = frame.hmax // c["h"], frame.vmax // c["v"]
        if frame.hmax % c["h"] or frame.vmax % c["v"]:
            raise ValueError("fractional JPEG sampling is not read")
        planes.append(_upsample(px, c["dsw"], c["dsh"], hx, vx)[:frame.height, :frame.width])
    if len(planes) == 1:
        return planes[0].astype(np.uint8)
    ids = [c["id"] for c in frame.comps]
    rgb = (not jfif and adobe == 0) or (not jfif and adobe is None and ids == [82, 71, 66])
    if rgb:
        return np.stack(planes, axis=-1).astype(np.uint8)
    return _ycc_to_rgb(*planes)


# --- encoding ---------------------------------------------------------------------

_LUMA_Q = np.array([
    16, 11, 10, 16, 24, 40, 51, 61, 12, 12, 14, 19, 26, 58, 60, 55,
    14, 13, 16, 24, 40, 57, 69, 56, 14, 17, 22, 29, 51, 87, 80, 62,
    18, 22, 37, 56, 68, 109, 103, 77, 24, 35, 55, 64, 81, 104, 113, 92,
    49, 64, 78, 87, 103, 121, 120, 101, 72, 92, 95, 98, 112, 100, 103, 99], np.int64)
_CHROMA_Q = np.full(64, 99, np.int64)
_CHROMA_Q[[0, 1, 2, 3, 8, 9, 10, 11, 16, 17, 18, 24, 25]] = [17, 18, 24, 47, 18, 21, 26, 66,
                                                             24, 26, 56, 47, 66]

# the standard Huffman tables (Annex K.3): 16 code counts, then the symbols
_STD_HUFF = {
    (0, 0): "00010501010101010100000000000000000102030405060708090a0b",
    (1, 0): "0002010303020403050504040000017d01020300041105122131410613516107227114328191a108"
            "2342b1c11552d1f02433627282090a161718191a25262728292a3435363738393a434445464748494a"
            "535455565758595a636465666768696a737475767778797a838485868788898a929394959697989"
            "99aa2a3a4a5a6a7a8a9aab2b3b4b5b6b7b8b9bac2c3c4c5c6c7c8c9cad2d3d4d5d6d7d8d9dae1e2e3"
            "e4e5e6e7e8e9eaf1f2f3f4f5f6f7f8f9fa",
    (0, 1): "00030101010101010101010000000000000102030405060708090a0b",
    (1, 1): "00020102040403040705040400010277000102031104052131061241510761711322328108144291"
            "a1b1c109233352f0156272d10a162434e125f11718191a262728292a35363738393a434445464748"
            "494a535455565758595a636465666768696a737475767778797a82838485868788898a929394959"
            "69798999aa2a3a4a5a6a7a8a9aab2b3b4b5b6b7b8b9bac2c3c4c5c6c7c8c9cad2d3d4d5d6d7d8d9da"
            "e2e3e4e5e6e7e8e9eaf2f3f4f5f6f7f8f9fa",
}


def quality_tables(quality: int) -> tuple:
    """The luminance and chrominance tables (natural order) of
    ``jpeg_set_quality(quality, force_baseline=TRUE)``."""
    q = min(max(int(quality), 1), 100)
    scale = 5000 // q if q < 50 else 200 - 2 * q
    return tuple(np.clip((t * scale + 50) // 100, 1, 255) for t in (_LUMA_Q, _CHROMA_Q))


def _huff_codes(spec: str):
    raw = bytes.fromhex(spec)
    bits, vals = raw[:16], raw[16:]
    codes, code, k = {}, 0, 0
    for n in range(1, 17):
        for _ in range(bits[n - 1]):
            codes[vals[k]] = (code, n)
            code += 1
            k += 1
        code <<= 1
    return raw, codes


def _rgb_to_ycc(rgb) -> tuple:
    """``jccolor.c`` rgb_ycc_convert: the fixed-point tables (16 bits), the
    chroma with its 0.5−ε rounding."""
    r, g, b = (rgb[..., i].astype(np.int64) for i in range(3))
    half = 1 << 15
    off = 128 << 16
    y = (round_fix(0.29900) * r + round_fix(0.58700) * g + round_fix(0.11400) * b + half) >> 16
    cb = (-round_fix(0.16874) * r - round_fix(0.33126) * g + round_fix(0.5) * b
          + off + half - 1) >> 16
    cr = (round_fix(0.5) * r - round_fix(0.41869) * g - round_fix(0.08131) * b
          + off + half - 1) >> 16
    return y, cb, cr


def _pad_edge(p, rows, cols):
    return np.pad(p, ((0, rows - p.shape[0]), (0, cols - p.shape[1])), mode="edge")


def _downsample_h2v2(p, out_rows, out_cols):
    """``jcsample.c`` h2v2_downsample over an edge-padded plane, bias 1,2,1,2
    along each output row."""
    q = _pad_edge(p, 2 * out_rows, 2 * out_cols)
    s = q[0::2, 0::2] + q[0::2, 1::2] + q[1::2, 0::2] + q[1::2, 1::2]
    bias = np.where(np.arange(out_cols) % 2 == 0, 1, 2)
    return (s + bias[None, :]) >> 2


def _fdct_1d(d0, d1, d2, d3, d4, d5, d6, d7, even_shift, odd_shift, first):
    tmp0, tmp7 = d0 + d7, d0 - d7
    tmp1, tmp6 = d1 + d6, d1 - d6
    tmp2, tmp5 = d2 + d5, d2 - d5
    tmp3, tmp4 = d3 + d4, d3 - d4
    t10, t13, t11, t12 = tmp0 + tmp3, tmp0 - tmp3, tmp1 + tmp2, tmp1 - tmp2
    if first:
        o0, o4 = (t10 + t11) << 2, (t10 - t11) << 2
    else:
        o0, o4 = _descale(t10 + t11, 2), _descale(t10 - t11, 2)
    z1 = (t12 + t13) * _F0541
    o2 = _descale(z1 + t13 * _F0765, even_shift)
    o6 = _descale(z1 - t12 * _F1847, even_shift)
    z1, z2, z3, z4 = tmp4 + tmp7, tmp5 + tmp6, tmp4 + tmp6, tmp5 + tmp7
    z5 = (z3 + z4) * _F1175
    tmp4, tmp5, tmp6, tmp7 = tmp4 * _F0298, tmp5 * _F2053, tmp6 * _F3072, tmp7 * _F1501
    z1, z2 = z1 * -_F0899, z2 * -_F2562
    z3, z4 = z3 * -_F1961 + z5, z4 * -_F0390 + z5
    o7 = _descale(tmp4 + z1 + z3, odd_shift)
    o5 = _descale(tmp5 + z2 + z4, odd_shift)
    o3 = _descale(tmp6 + z2 + z3, odd_shift)
    o1 = _descale(tmp7 + z1 + z4, odd_shift)
    return o0, o1, o2, o3, o4, o5, o6, o7


def fdct_islow(samples) -> np.ndarray:
    """u8 [...,8,8] → ``jpeg_fdct_islow`` coefficients (scaled by 8)."""
    x = samples.astype(np.int64) - 128
    rows = _fdct_1d(*(x[..., :, c] for c in range(8)), 11, 11, True)
    ws = np.stack(rows, axis=-1)
    cols = _fdct_1d(*(ws[..., r, :] for r in range(8)), 15, 15, False)
    return np.stack(cols, axis=-2)


def _reciprocal(divisor: int) -> tuple:
    """``compute_reciprocal`` of libjpeg-turbo (16-bit DCT elements):
    (reciprocal, correction, total shift)."""
    b = divisor.bit_length() - 1
    r = 16 + b
    fq, fr = divmod(1 << r, divisor)
    c = divisor // 2
    if fr == 0:
        fq >>= 1
        r -= 1
    elif fr <= divisor // 2:
        c += 1
    else:
        fq += 1
    return fq, c, r


def quantize(coef, qt) -> np.ndarray:
    """FDCT output [...,8,8] → quantized coefficients, as libjpeg-turbo's
    reciprocal quantizer rounds them (divisor = 8·q)."""
    rec = [_reciprocal(int(q) * 8) for q in np.asarray(qt).reshape(-1)]
    fq = np.array([r[0] for r in rec], np.int64).reshape(8, 8)
    c = np.array([r[1] for r in rec], np.int64).reshape(8, 8)
    sh = np.array([r[2] for r in rec], np.int64).reshape(8, 8)
    mag = ((np.abs(coef) + c) * fq) >> sh
    return np.where(coef < 0, -mag, mag)


class _BitWriter:
    def __init__(self):
        self.out = bytearray()
        self.acc, self.n = 0, 0

    def put(self, code, size):
        self.acc = (self.acc << size) | (code & ((1 << size) - 1))
        self.n += size
        while self.n >= 8:
            self.n -= 8
            byte = (self.acc >> self.n) & 0xFF
            self.out.append(byte)
            if byte == 0xFF:
                self.out.append(0)
        self.acc &= (1 << self.n) - 1

    def flush(self):
        """Fill the partial byte with ones (libjpeg's flush_bits)."""
        if self.n:
            self.put(0x7F, 7)
            self.acc, self.n = 0, 0


def _blocks_of(plane, bh, bw):
    return plane[:bh * 8, :bw * 8].reshape(bh, 8, bw, 8).transpose(0, 2, 1, 3)


def encode(image_u8, quality: int = 92) -> bytes:
    """u8 [H,W] (greyscale) or [H,W,3|4] (RGB; alpha dropped) → the bytes
    of the JPEG PIL writes for it at ``quality``."""
    img = np.asarray(image_u8)
    if img.dtype != np.uint8:
        raise ValueError(f"save_jpeg takes u8 images, got {img.dtype}")
    if img.ndim == 3 and img.shape[-1] == 4:
        img = img[..., :3]
    if not (img.ndim == 2 or (img.ndim == 3 and img.shape[-1] == 3)):
        raise ValueError(f"save_jpeg takes u8 [H,W] or [H,W,3|4], got {img.shape}")
    h, w = img.shape[:2]
    luma_q, chroma_q = quality_tables(quality)
    grey = img.ndim == 2
    if grey:
        comps = [(img.astype(np.int64), 1, 1, 0)]
    else:
        y, cb, cr = _rgb_to_ycc(img)
        comps = [(y, 2, 2, 0), (cb, 1, 1, 1), (cr, 1, 1, 1)]
    hmax = max(c[1] for c in comps)
    vmax = max(c[2] for c in comps)
    mcux, mcuy = -(-w // (8 * hmax)), -(-h // (8 * vmax))
    tables = (luma_q, chroma_q)
    quant = []  # per component: quantized blocks [bh_real, bw_real, 64] (natural order)
    for plane, hs, vs, tq in comps:
        bw, bh = -(-w * hs // (8 * hmax)), -(-h * vs // (8 * vmax))
        if hs == hmax and vs == vmax:
            full = _pad_edge(plane, -(-h // vmax) * vmax, bw * 8)
            full = _pad_edge(full, bh * 8, bw * 8)
        else:
            rows = -(-h // vmax) * vmax
            cs = _downsample_h2v2(_pad_edge(plane, rows, plane.shape[1]), rows // 2, bw * 8)
            full = _pad_edge(cs, bh * 8, bw * 8)
        coef = quantize(fdct_islow(_blocks_of(full, bh, bw)), tables[tq].reshape(8, 8))
        quant.append(coef.reshape(bh, bw, 64))
    dc_codes = {t: _huff_codes(_STD_HUFF[(0, t)]) for t in (0, 1)}
    ac_codes = {t: _huff_codes(_STD_HUFF[(1, t)]) for t in (0, 1)}
    bits = _BitWriter()
    last_dc = [0] * len(comps)
    zz = _ZZ
    for my in range(mcuy):
        for mx in range(mcux):
            for ci, (_, hs, vs, tq) in enumerate(comps):
                q = quant[ci]
                bh, bw = q.shape[:2]
                mcu_dc = []
                for vi in range(vs):
                    for hi in range(hs):
                        by, bx = my * vs + vi, mx * hs + hi
                        if by < bh and bx < bw:
                            blk = q[by, bx].tolist()
                        else:  # a dummy block past the edge: the DC of the one before
                            blk = [mcu_dc[-1]] + [0] * 63
                        mcu_dc.append(blk[0])
                        _encode_block(bits, blk, last_dc, ci, dc_codes[tq][1], ac_codes[tq][1],
                                      zz)
    bits.flush()
    return _headers(w, h, comps, tables, dc_codes, ac_codes) + bytes(bits.out) + b"\xff\xd9"


def _encode_block(bits, blk, last_dc, ci, dc, ac, zz):
    diff = blk[0] - last_dc[ci]
    last_dc[ci] = blk[0]
    t, t2 = (diff, diff) if diff >= 0 else (-diff, diff - 1)
    nb = t.bit_length()
    bits.put(*dc[nb])
    if nb:
        bits.put(t2, nb)
    r = 0
    for k in range(1, 64):
        v = blk[zz[k]]
        if v == 0:
            r += 1
            continue
        while r > 15:
            bits.put(*ac[0xF0])
            r -= 16
        t, t2 = (v, v) if v >= 0 else (-v, v - 1)
        nb = t.bit_length()
        bits.put(*ac[(r << 4) + nb])
        bits.put(t2, nb)
        r = 0
    if r > 0:
        bits.put(*ac[0x00])


def _marker(m, body):
    return bytes([0xFF, m]) + struct.pack(">H", len(body) + 2) + body


def _headers(w, h, comps, tables, dc_codes, ac_codes) -> bytes:
    used = sorted({c[3] for c in comps})
    out = b"\xff\xd8" + _marker(0xE0, b"JFIF\x00\x01\x01\x00\x00\x01\x00\x01\x00\x00")
    for t in used:
        out += _marker(0xDB, bytes([t]) + bytes(tables[t][ZIGZAG].astype(np.uint8).tolist()))
    sof = struct.pack(">BHHB", 8, h, w, len(comps))
    for i, (_, hs, vs, tq) in enumerate(comps):
        sof += bytes([i + 1, (hs << 4) | vs, tq])
    out += _marker(0xC0, sof)
    for t in used:
        out += _marker(0xC4, bytes([t]) + dc_codes[t][0])
        out += _marker(0xC4, bytes([0x10 | t]) + ac_codes[t][0])
    sos = bytes([len(comps)])
    for i, (_, _, _, tq) in enumerate(comps):
        sos += bytes([i + 1, (tq << 4) | tq])
    return out + _marker(0xDA, sos + b"\x00\x3f\x00")
