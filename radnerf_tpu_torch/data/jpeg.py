"""A baseline JPEG codec in numpy, for machines without an image library.

`decode_jpeg` reads baseline sequential DCT files (SOF0 and SOF1), 8-bit,
Huffman coded, with 1 or 3 components, luma sampled 1x1, 2x1 or 2x2
against chroma 1x1, with or without restart intervals, interleaved or
not. Its output equals libjpeg-turbo's default decode (what PIL and
imageio return): the ISLOW integer IDCT of jidctint.c, the "fancy"
triangle upsampling of jdsample.c and the fixed-point YCbCr -> RGB of
jdcolor.c. Progressive, lossless, arithmetic-coded and 12-bit files raise
ValueError naming what is missing.

The entropy decode is a per-symbol Python loop over a 16-bit look-ahead
window of the bit stream; the IDCT, the upsampling and the colour
conversion are vectorized. A 1296x968 image takes seconds, so the loaders
use it only where imageio is missing (see color_utils.imread).

`encode_jpeg` writes baseline 4:4:4 or 4:2:0 (or gray) files with
libjpeg's quality scaling of the Annex K quantization tables and the
standard Huffman tables; it writes the scenes of the tests and the smoke
run where no image library is installed.
"""

from __future__ import annotations

import re
import struct

import numpy as np

SOI = b"\xff\xd8"

# k-th coefficient of the zigzag scan -> its index in the natural 8x8
# order (jpeg_natural_order of jutils.c)
ZIGZAG = np.array([
    0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6, 7, 14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63])
_UNZIGZAG = np.argsort(ZIGZAG)

_UNSUPPORTED = {
    0xC2: "progressive DCT", 0xC3: "lossless", 0xC5: "differential "
    "sequential DCT", 0xC6: "differential progressive DCT", 0xC7:
    "differential lossless", 0xC9: "arithmetic-coded sequential DCT",
    0xCA: "arithmetic-coded progressive DCT", 0xCB: "arithmetic-coded "
    "lossless", 0xCD: "arithmetic-coded differential sequential DCT", 0xCE:
    "arithmetic-coded differential progressive DCT", 0xCF: "arithmetic-"
    "coded differential lossless",
}
# the end of an entropy-coded segment: 0xFF not followed by a stuffed 0
# or a restart marker
_SEGMENT_END = re.compile(rb"\xff(?!\x00)(?![\xd0-\xd7])")
_RESTART = re.compile(rb"\xff[\xd0-\xd7]")


def _huffman_lut(counts: bytes, symbols: bytes) -> list:
    """A 65536-entry table from a 16-bit look-ahead to (length << 8) |
    symbol; 0 where no code starts with those bits."""
    lut = np.zeros(1 << 16, np.int32)
    code, k = 0, 0
    for length in range(1, 17):
        for _ in range(counts[length - 1]):
            lo = code << (16 - length)
            lut[lo:lo + (1 << (16 - length))] = (length << 8) | symbols[k]
            code += 1
            k += 1
        code <<= 1
    return lut.tolist()


def _window(part: bytes) -> memoryview:
    """The 16 bits starting at every bit position of an unstuffed
    entropy-coded segment (zeros past its end, as libjpeg inserts)."""
    b = np.frombuffer(part + bytes(8), np.uint8).astype(np.uint32)
    w24 = (b[:-2] << 16) | (b[1:-1] << 8) | b[2:]
    p = np.arange((len(part) + 4) * 8)
    w = (w24[p >> 3] >> (8 - (p & 7)).astype(np.uint32)) & 0xFFFF
    return memoryview(w.astype(np.uint16).tobytes()).cast("H")


class _Frame:
    """The frame header and the tables met so far."""

    def __init__(self):
        self.qt = {}                    # id -> (64,) natural order
        self.dc, self.ac = {}, {}       # id -> lookup table
        self.restart = 0
        self.comps = None               # [(id, h, v, tq)]
        self.size = None                # (height, width)
        self.adobe = None               # Adobe APP14 transform flag
        self.jfif = False


def _blocks_shape(f: _Frame, ci: int) -> tuple:
    """(block rows, block cols) of component ci, padded to whole MCUs."""
    hmax = max(c[1] for c in f.comps)
    vmax = max(c[2] for c in f.comps)
    h, w = f.size
    mcux, mcuy = -(-w // (8 * hmax)), -(-h // (8 * vmax))
    return mcuy * f.comps[ci][2], mcux * f.comps[ci][1]


def _decode_scan(f: _Frame, scan: list, parts: list, coefs: list) -> None:
    """Huffman-decode one scan's segments into the zigzag-ordered
    coefficient lists of its components. scan: [(ci, dc id, ac id)]."""
    hmax = max(c[1] for c in f.comps)
    vmax = max(c[2] for c in f.comps)
    h, w = f.size
    if len(scan) == 1:                  # non-interleaved: one block an MCU
        ci = scan[0][0]
        _, ch, cv, _ = f.comps[ci]
        bw = -(-(-(-w * ch // hmax)) // 8)
        bh = -(-(-(-h * cv // vmax)) // 8)
        stride = _blocks_shape(f, ci)[1]
        order = [[(0, (by * stride + bx) * 64)] for by in range(bh)
                 for bx in range(bw)]
    else:
        mcux, mcuy = -(-w // (8 * hmax)), -(-h // (8 * vmax))
        order = []
        for my in range(mcuy):
            for mx in range(mcux):
                mcu = []
                for si, (ci, _, _) in enumerate(scan):
                    _, ch, cv, _ = f.comps[ci]
                    stride = mcux * ch
                    mcu += [(si, ((my * cv + v) * stride + mx * ch + u) * 64)
                            for v in range(cv) for u in range(ch)]
                order.append(mcu)
    luts = [(f.dc[td], f.ac[ta]) for _, td, ta in scan]
    outs = [coefs[ci] for ci, _, _ in scan]
    per = f.restart or len(order)
    if len(parts) < -(-len(order) // per):
        raise ValueError("JPEG scan ends before its last MCU")
    for start in range(0, len(order), per):
        win = _window(parts[start // per].replace(b"\xff\x00", b"\xff"))
        pos = 0
        pred = [0] * len(scan)
        for mcu in order[start:start + per]:
            for si, base in mcu:
                lut_dc, lut_ac = luts[si]
                out = outs[si]
                e = lut_dc[win[pos]]
                if not e:
                    raise ValueError("JPEG data holds an invalid Huffman code")
                pos += e >> 8
                s = e & 255
                if s:
                    v = win[pos] >> (16 - s)
                    pos += s
                    if v < (1 << (s - 1)):
                        v -= (1 << s) - 1
                    pred[si] += v
                out[base] = pred[si]
                k = 1
                while k < 64:
                    e = lut_ac[win[pos]]
                    if not e:
                        raise ValueError(
                            "JPEG data holds an invalid Huffman code")
                    pos += e >> 8
                    s = e & 15
                    if not s:
                        if e & 255 != 0xF0:       # end of block
                            break
                        k += 16                   # a run of 16 zeros
                        continue
                    k += (e & 255) >> 4
                    v = win[pos] >> (16 - s)
                    pos += s
                    if v < (1 << (s - 1)):
                        v -= (1 << s) - 1
                    out[base + k] = v
                    k += 1
                if k > 64:
                    raise ValueError("JPEG block runs past 64 coefficients")
                if pos > len(win) - 16:
                    raise ValueError("JPEG scan ends before its last MCU")


# ------------------------------------------------------------ inverse DCT
_CONST_BITS, _PASS1_BITS = 13, 2
_F = dict(f0298=2446, f0390=3196, f0541=4433, f0765=6270, f0899=7373,
          f1175=9633, f1501=12299, f1847=15137, f1961=16069, f2053=16819,
          f2562=20995, f3072=25172)


def _idct_1d(x):
    """jidctint.c's 1-D stage on the 8 inputs x[0..7] (int64 arrays):
    the 8 outputs before their descale, scaled by 2^CONST_BITS."""
    f = _F
    z1 = (x[2] + x[6]) * f["f0541"]
    tmp2 = z1 - x[6] * f["f1847"]
    tmp3 = z1 + x[2] * f["f0765"]
    tmp0 = (x[0] + x[4]) << _CONST_BITS
    tmp1 = (x[0] - x[4]) << _CONST_BITS
    tmp10, tmp13 = tmp0 + tmp3, tmp0 - tmp3
    tmp11, tmp12 = tmp1 + tmp2, tmp1 - tmp2
    t0, t1, t2, t3 = x[7], x[5], x[3], x[1]
    z1, z2, z3, z4 = t0 + t3, t1 + t2, t0 + t2, t1 + t3
    z5 = (z3 + z4) * f["f1175"]
    t0, t1 = t0 * f["f0298"], t1 * f["f2053"]
    t2, t3 = t2 * f["f3072"], t3 * f["f1501"]
    z1, z2 = -z1 * f["f0899"], -z2 * f["f2562"]
    z3, z4 = -z3 * f["f1961"] + z5, -z4 * f["f0390"] + z5
    t0, t1 = t0 + z1 + z3, t1 + z2 + z4
    t2, t3 = t2 + z2 + z3, t3 + z1 + z4
    return [tmp10 + t3, tmp11 + t2, tmp12 + t1, tmp13 + t0,
            tmp13 - t0, tmp12 - t1, tmp11 - t2, tmp10 - t3]


def _descale(x, n):
    return (x + (1 << (n - 1))) >> n


# the post-IDCT range limit of jdmaster.c, indexed by value & 1023
_RANGE_LIMIT = np.concatenate([
    np.arange(128, 256), np.full(384, 255), np.zeros(384),
    np.arange(0, 128)]).astype(np.uint8)


def idct_islow(coef: np.ndarray) -> np.ndarray:
    """(..., 8, 8) dequantized coefficients (natural order, rows v, cols
    u) -> (..., 8, 8) uint8 samples, as libjpeg's jpeg_idct_islow: columns
    first, then rows, with its descales and range limit."""
    c = coef.astype(np.int64)
    cols = _idct_1d([c[..., k, :] for k in range(8)])
    ws = np.stack([_descale(v, _CONST_BITS - _PASS1_BITS) for v in cols],
                  axis=-2)
    rows = _idct_1d([ws[..., k] for k in range(8)])
    out = np.stack([_descale(v, _CONST_BITS + _PASS1_BITS + 3)
                    for v in rows], axis=-1)
    return _RANGE_LIMIT[out & 1023]


# ------------------------------------------------------------- upsampling
def _fancy_h2v1(p: np.ndarray) -> np.ndarray:
    """jdsample.c's h2v1_fancy_upsample: 3/4 of the nearer sample and 1/4
    of the further one, biased 1 (even outputs) and 2 (odd)."""
    p = p.astype(np.int32)
    pad = np.pad(p, ((0, 0), (1, 1)), mode="edge")
    out = np.empty((p.shape[0], 2 * p.shape[1]), np.int32)
    out[:, 0::2] = (3 * p + pad[:, :-2] + 1) >> 2
    out[:, 1::2] = (3 * p + pad[:, 2:] + 2) >> 2
    return out


def _fancy_h2v2(p: np.ndarray) -> np.ndarray:
    """jdsample.c's h2v2_fancy_upsample: column sums 3 * nearer row +
    further row, then 3 * nearer sum + further sum, biased 8 (even
    columns) and 7 (odd); the image's edge rows and columns repeat."""
    p = p.astype(np.int32)
    rows = np.pad(p, ((1, 1), (0, 0)), mode="edge")
    out = np.empty((2 * p.shape[0], 2 * p.shape[1]), np.int32)
    for v, other in ((0, rows[:-2]), (1, rows[2:])):
        s = 3 * p + other
        pad = np.pad(s, ((0, 0), (1, 1)), mode="edge")
        out[v::2, 0::2] = (3 * s + pad[:, :-2] + 8) >> 4
        out[v::2, 1::2] = (3 * s + pad[:, 2:] + 7) >> 4
    return out


def _upsample(p: np.ndarray, fh: int, fv: int) -> np.ndarray:
    """A chroma plane upsampled by (fh, fv): fancy where jdsample.c is
    (more than 2 samples wide), else replicated."""
    if (fh, fv) == (1, 1):
        return p.astype(np.int32)
    fancy = p.shape[1] > 2
    if (fh, fv) == (2, 1) and fancy:
        return _fancy_h2v1(p)
    if (fh, fv) == (2, 2) and fancy:
        return _fancy_h2v2(p)
    if (fh, fv) in ((2, 1), (2, 2)):
        return np.repeat(np.repeat(p, fv, axis=0), fh, axis=1).astype(
            np.int32)
    raise ValueError(f"JPEG chroma sampling {fh}x{fv} below luma is not "
                     "supported (1x1, 2x1 and 2x2 are)")


# ------------------------------------------------------ colour conversion
def _ycc_tables():
    """jdcolor.c's build_ycc_rgb_table (SCALEBITS 16)."""
    one_half = 1 << 15

    def fix(x):
        return int(x * (1 << 16) + 0.5)

    x = np.arange(256, dtype=np.int64) - 128
    cr_r = (fix(1.40200) * x + one_half) >> 16
    cb_b = (fix(1.77200) * x + one_half) >> 16
    cr_g = -fix(0.71414) * x
    cb_g = -fix(0.34414) * x + one_half
    return cr_r, cb_b, cr_g, cb_g


_CR_R, _CB_B, _CR_G, _CB_G = _ycc_tables()


def ycc_to_rgb(y, cb, cr) -> np.ndarray:
    """jdcolor.c's ycc_rgb_convert of uint8-range planes -> (H, W, 3)
    uint8."""
    y = y.astype(np.int64)
    r = y + _CR_R[cr]
    g = y + ((_CB_G[cb] + _CR_G[cr]) >> 16)
    b = y + _CB_B[cb]
    return np.clip(np.stack([r, g, b], axis=-1), 0, 255).astype(np.uint8)


# ----------------------------------------------------------------- decode
def _next_segment(data: bytes, pos: int):
    """(marker, payload, offset after it) of the marker segment at `pos`,
    or None at EOI or the end of the data; SOS's payload is its header."""
    while True:
        if pos >= len(data):
            return None
        if data[pos] != 0xFF:
            raise ValueError(f"JPEG marker expected at byte {pos}")
        while pos < len(data) and data[pos] == 0xFF:   # fill bytes
            pos += 1
        if pos >= len(data) or data[pos] == 0xD9:       # EOI
            return None
        marker = data[pos]
        pos += 1
        if not (0xD0 <= marker <= 0xD7 or marker == 0x01):   # no payload
            break
    if pos + 2 > len(data):
        raise ValueError("truncated JPEG segment")
    (length,) = struct.unpack(">H", data[pos:pos + 2])
    payload = data[pos + 2:pos + length]
    if len(payload) != length - 2:
        raise ValueError("truncated JPEG segment")
    return marker, payload, pos + length


def _segments(data: bytes):
    """The marker segments of a JPEG file up to its first scan."""
    if data[:2] != SOI:
        raise ValueError("not a JPEG file (no SOI marker)")
    pos = 2
    while (seg := _next_segment(data, pos)) is not None:
        yield seg
        if seg[0] == 0xDA:
            return
        pos = seg[2]


def _read_header(f: _Frame, marker: int, p: bytes) -> None:
    if marker in (0xC0, 0xC1):
        precision, h, w, n = struct.unpack(">BHHB", p[:6])
        if precision != 8:
            raise ValueError(f"{precision}-bit JPEG is not supported "
                             "(8-bit is)")
        if h == 0:
            raise ValueError("JPEG height given by a DNL marker is not "
                             "supported")
        f.size = (h, w)
        f.comps = [(p[6 + 3 * i], p[7 + 3 * i] >> 4, p[7 + 3 * i] & 15,
                    p[8 + 3 * i]) for i in range(n)]
        if n not in (1, 3):
            raise ValueError(f"JPEG with {n} components is not supported "
                             "(1 and 3 are)")
    elif marker in _UNSUPPORTED:
        raise ValueError(f"{_UNSUPPORTED[marker]} JPEG is not supported "
                         "(baseline sequential DCT is)")
    elif marker == 0xC4:                                 # DHT
        i = 0
        while i < len(p):
            tc, th = p[i] >> 4, p[i] & 15
            counts = p[i + 1:i + 17]
            n = sum(counts)
            lut = _huffman_lut(counts, p[i + 17:i + 17 + n])
            (f.dc if tc == 0 else f.ac)[th] = lut
            i += 17 + n
    elif marker == 0xDB:                                 # DQT
        i = 0
        while i < len(p):
            pq, tq = p[i] >> 4, p[i] & 15
            if pq:
                vals = np.frombuffer(p[i + 1:i + 129], ">u2")
                i += 129
            else:
                vals = np.frombuffer(p[i + 1:i + 65], np.uint8)
                i += 65
            table = np.zeros(64, np.int64)
            table[ZIGZAG] = vals
            f.qt[tq] = table
    elif marker == 0xDD:                                 # DRI
        (f.restart,) = struct.unpack(">H", p[:2])
    elif marker == 0xE0 and p[:5] == b"JFIF\x00":
        f.jfif = True
    elif marker == 0xEE and p[:5] == b"Adobe" and len(p) >= 12:
        f.adobe = p[11]
    elif marker == 0xDC:
        raise ValueError("JPEG DNL marker is not supported")


def _is_rgb(f: _Frame) -> bool:
    """Whether 3 components are RGB rather than YCbCr (libjpeg's
    default_decompress_parms)."""
    if f.jfif:
        return False
    if f.adobe is not None:
        return f.adobe == 0
    return [c[0] for c in f.comps] == [82, 71, 66]      # 'R', 'G', 'B'


def decode_jpeg(data: bytes) -> np.ndarray:
    """JPEG bytes -> uint8 (H, W) for gray, (H, W, 3) RGB otherwise."""
    if data[:2] != SOI:
        raise ValueError("not a JPEG file (no SOI marker)")
    f = _Frame()
    coefs, quant = None, {}
    pos = 2
    while (seg := _next_segment(data, pos)) is not None:
        marker, p, pos = seg
        if marker != 0xDA:
            _read_header(f, marker, p)
            continue
        if f.comps is None:
            raise ValueError("JPEG scan before its frame header")
        if coefs is None:
            coefs = [[0] * (int(np.prod(_blocks_shape(f, ci))) * 64)
                     for ci in range(len(f.comps))]
        ids = [c[0] for c in f.comps]
        scan = []
        for i in range(p[0]):
            ci = ids.index(p[1 + 2 * i])
            td, ta = p[2 + 2 * i] >> 4, p[2 + 2 * i] & 15
            if td not in f.dc or ta not in f.ac:
                raise ValueError("JPEG scan names a Huffman table it lacks")
            scan.append((ci, td, ta))
            quant.setdefault(ci, f.qt[f.comps[ci][3]])
        m = _SEGMENT_END.search(data, pos)
        stop = m.start() if m else len(data)
        _decode_scan(f, scan, _RESTART.split(data[pos:stop]), coefs)
        pos = stop
    if coefs is None:
        raise ValueError("JPEG without a scan")
    h, w = f.size
    hmax = max(c[1] for c in f.comps)
    vmax = max(c[2] for c in f.comps)
    planes = []
    for ci, (_, ch, cv, _) in enumerate(f.comps):
        if ci not in quant:
            raise ValueError("JPEG component without a scan")
        if hmax % ch or vmax % cv:
            raise ValueError("JPEG sampling factors are not supported")
        bh, bw = _blocks_shape(f, ci)
        zz = np.array(coefs[ci], np.int64).reshape(bh, bw, 64)
        nat = (zz[..., _UNZIGZAG] * quant[ci]).reshape(bh, bw, 8, 8)
        plane = idct_islow(nat).transpose(0, 2, 1, 3).reshape(bh * 8,
                                                              bw * 8)
        plane = plane[:-(-h * cv // vmax), :-(-w * ch // hmax)]
        planes.append(_upsample(plane, hmax // ch, vmax // cv)[:h, :w])
    if len(planes) == 1:
        return planes[0].astype(np.uint8)
    if _is_rgb(f):
        return np.stack(planes, axis=-1).astype(np.uint8)
    return ycc_to_rgb(*planes)


def read_jpeg(path: str) -> np.ndarray:
    with open(path, "rb") as fh:
        return decode_jpeg(fh.read())


def jpeg_size(data: bytes) -> tuple[int, int]:
    """(width, height) from the frame header of JPEG bytes (any SOFn)."""
    for marker, p, _ in _segments(data):
        if 0xC0 <= marker <= 0xCF and marker not in (0xC4, 0xC8, 0xCC):
            h, w = struct.unpack(">HH", p[1:5])
            return w, h
        if marker == 0xDA:
            break
    raise ValueError("JPEG without a frame header")


# ----------------------------------------------------------------- encode
# Annex K.1 quantization tables, natural order
_STD_LUMA_Q = np.array([
    16, 11, 10, 16, 24, 40, 51, 61, 12, 12, 14, 19, 26, 58, 60, 55,
    14, 13, 16, 24, 40, 57, 69, 56, 14, 17, 22, 29, 51, 87, 80, 62,
    18, 22, 37, 56, 68, 109, 103, 77, 24, 35, 55, 64, 81, 104, 113, 92,
    49, 64, 78, 87, 103, 121, 120, 101, 72, 92, 95, 98, 112, 100, 103, 99])
_STD_CHROMA_Q = np.array([
    17, 18, 24, 47, 99, 99, 99, 99, 18, 21, 26, 66, 99, 99, 99, 99,
    24, 26, 56, 99, 99, 99, 99, 99, 47, 66, 99, 99, 99, 99, 99, 99,
    99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99,
    99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99])
# Annex K.3 Huffman tables: (counts of code lengths 1-16, symbols)
_DC_LUMA = (bytes([0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0]),
            bytes(range(12)))
_DC_CHROMA = (bytes([0, 3, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0]),
              bytes(range(12)))
_AC_LUMA = (bytes([0, 2, 1, 3, 3, 2, 4, 3, 5, 5, 4, 4, 0, 0, 1, 0x7D]),
            bytes.fromhex(
                "01020300041105122131410613516107227114328191a1082342b1c1"
                "1552d1f02433627282090a161718191a25262728292a343536373839"
                "3a434445464748494a535455565758595a636465666768696a737475"
                "767778797a838485868788898a92939495969798999aa2a3a4a5a6a7"
                "a8a9aab2b3b4b5b6b7b8b9bac2c3c4c5c6c7c8c9cad2d3d4d5d6d7d8"
                "d9dae1e2e3e4e5e6e7e8e9eaf1f2f3f4f5f6f7f8f9fa"))
_AC_CHROMA = (bytes([0, 2, 1, 2, 4, 4, 3, 4, 7, 5, 4, 4, 0, 1, 2, 0x77]),
              bytes.fromhex(
                  "0001020311040521310612415107617113223281081442"
                  "91a1b1c109233352f0156272d10a162434e125f1171819"
                  "1a262728292a35363738393a434445464748494a535455"
                  "565758595a636465666768696a737475767778797a8283"
                  "8485868788898a92939495969798999aa2a3a4a5a6a7a8"
                  "a9aab2b3b4b5b6b7b8b9bac2c3c4c5c6c7c8c9cad2d3d4"
                  "d5d6d7d8d9dae2e3e4e5e6e7e8e9eaf2f3f4f5f6f7f8f9fa"))


def quality_tables(quality: int) -> tuple[np.ndarray, np.ndarray]:
    """libjpeg's jpeg_set_quality (jcparam.c) of the Annex K tables:
    (luma, chroma), natural order, baseline (at most 255)."""
    quality = min(max(int(quality), 1), 100)
    scale = 5000 // quality if quality < 50 else 200 - quality * 2
    return tuple(np.clip((t * scale + 50) // 100, 1, 255)
                 for t in (_STD_LUMA_Q, _STD_CHROMA_Q))


def _huffman_codes(table) -> dict:
    """symbol -> (code, length) of a (counts, symbols) table."""
    counts, symbols = table
    codes, code, k = {}, 0, 0
    for length in range(1, 17):
        for _ in range(counts[length - 1]):
            codes[symbols[k]] = (code, length)
            code += 1
            k += 1
        code <<= 1
    return codes


def _fdct_matrix() -> np.ndarray:
    u = np.arange(8)[:, None]
    x = np.arange(8)[None, :]
    c = np.where(u == 0, np.sqrt(0.5), 1.0)
    return c / 2 * np.cos((2 * x + 1) * u * np.pi / 16)


def _to_blocks(plane: np.ndarray, bh: int, bw: int) -> np.ndarray:
    """(H, W) -> edge-padded (bh, bw, 8, 8) blocks."""
    h, w = plane.shape
    p = np.pad(plane, ((0, bh * 8 - h), (0, bw * 8 - w)), mode="edge")
    return p.reshape(bh, 8, bw, 8).transpose(0, 2, 1, 3)


def _pack_bits(codes: list, lens: list) -> bytes:
    """Concatenate the codes MSB first, pad with 1 bits, stuff 0xFF."""
    codes = np.asarray(codes, np.int64)
    lens = np.asarray(lens, np.int64)
    idx = np.repeat(np.arange(len(lens)), lens)
    first = np.repeat(np.cumsum(lens) - lens, lens)
    j = np.arange(int(lens.sum())) - first
    bits = (codes[idx] >> (lens[idx] - 1 - j)) & 1
    bits = np.concatenate([bits, np.ones(-len(bits) % 8, np.int64)])
    return np.packbits(bits.astype(np.uint8)).tobytes().replace(
        b"\xff", b"\xff\x00")


def encode_jpeg(img: np.ndarray, quality: int = 90,
                subsampling: str = "4:2:0") -> bytes:
    """uint8 (H, W) gray or (H, W, 3) RGB -> baseline JFIF bytes, chroma
    subsampled "4:2:0" or "4:4:4"."""
    img = np.asarray(img)
    if img.dtype != np.uint8 or not (img.ndim == 2 or (
            img.ndim == 3 and img.shape[2] == 3)):
        raise ValueError(f"JPEG writer takes uint8 (H, W) or (H, W, 3), not "
                         f"{img.dtype} {img.shape}")
    if subsampling not in ("4:2:0", "4:4:4"):
        raise ValueError(f"subsampling {subsampling!r}: 4:2:0 or 4:4:4")
    h, w = img.shape[:2]
    q_luma, q_chroma = quality_tables(quality)
    if img.ndim == 2:
        planes, samp = [img.astype(np.float64)], [(1, 1)]
    else:
        rgb = img.astype(np.float64)
        r, g, b = rgb[..., 0], rgb[..., 1], rgb[..., 2]
        planes = [0.299 * r + 0.587 * g + 0.114 * b,
                  -0.168736 * r - 0.331264 * g + 0.5 * b + 128,
                  0.5 * r - 0.418688 * g - 0.081312 * b + 128]
        planes = [np.clip(np.floor(p + 0.5), 0, 255) for p in planes]
        f = 2 if subsampling == "4:2:0" else 1
        samp = [(f, f), (1, 1), (1, 1)]
    hmax = samp[0][0]
    mcux, mcuy = -(-w // (8 * hmax)), -(-h // (8 * hmax))
    dct = _fdct_matrix()
    blocks = []                  # per component: (bh, bw, 64) zigzag ints
    for ci, plane in enumerate(planes):
        if ci and hmax == 2:     # 2x2 average of the edge-padded plane
            pp = np.pad(plane, ((0, mcuy * 16 - h), (0, mcux * 16 - w)),
                        mode="edge")
            plane = pp.reshape(mcuy * 8, 2, mcux * 8, 2).mean(axis=(1, 3))
        bh, bw = mcuy * samp[ci][1], mcux * samp[ci][0]
        blk = _to_blocks(plane - 128.0, bh, bw)
        coef = dct @ blk @ dct.T
        q = (q_luma if ci == 0 else q_chroma).reshape(8, 8)
        zz = np.round(coef / q).astype(np.int64).reshape(bh, bw, 64)
        blocks.append(zz[..., ZIGZAG])
    tables = [(_huffman_codes(_DC_LUMA), _huffman_codes(_AC_LUMA)),
              (_huffman_codes(_DC_CHROMA), _huffman_codes(_AC_CHROMA))]
    # the nonzero AC coefficients of every block, grouped by block
    nz = []
    for zz in blocks:
        flat = zz.reshape(-1, 64)
        rows, ks = np.nonzero(flat[:, 1:])
        vals = flat[:, 1:][rows, ks]
        cuts = np.searchsorted(rows, np.arange(len(flat) + 1))
        nz.append((flat[:, 0].tolist(), (ks + 1).tolist(), vals.tolist(),
                   cuts.tolist()))
    codes, lens = [], []
    pred = [0] * len(planes)
    for my in range(mcuy):
        for mx in range(mcux):
            for ci in range(len(planes)):
                ch, cv = samp[ci]
                dc_codes, ac_codes = tables[min(ci, 1)]
                dcs, ks, vals, cuts = nz[ci]
                bw = mcux * ch
                for v in range(cv):
                    for u in range(ch):
                        bi = (my * cv + v) * bw + mx * ch + u
                        diff = dcs[bi] - pred[ci]
                        pred[ci] = dcs[bi]
                        s = abs(diff).bit_length()
                        c, n = dc_codes[s]
                        codes.append(c)
                        lens.append(n)
                        if s:
                            codes.append(diff if diff > 0
                                         else diff + (1 << s) - 1)
                            lens.append(s)
                        prev = 0
                        for j in range(cuts[bi], cuts[bi + 1]):
                            k, val = ks[j], vals[j]
                            run = k - prev - 1
                            while run > 15:
                                c, n = ac_codes[0xF0]
                                codes.append(c)
                                lens.append(n)
                                run -= 16
                            s = abs(val).bit_length()
                            c, n = ac_codes[(run << 4) | s]
                            codes.append(c)
                            lens.append(n)
                            codes.append(val if val > 0
                                         else val + (1 << s) - 1)
                            lens.append(s)
                            prev = k
                        if prev != 63:
                            c, n = ac_codes[0x00]
                            codes.append(c)
                            lens.append(n)

    def seg(marker: int, body: bytes) -> bytes:
        return bytes([0xFF, marker]) + struct.pack(">H", len(body) + 2) + body

    n = len(planes)
    out = SOI + seg(0xE0, b"JFIF\x00\x01\x01\x00\x00\x01\x00\x01\x00\x00")
    out += seg(0xDB, bytes([0]) + bytes(q_luma[ZIGZAG].astype(np.uint8)))
    if n == 3:
        out += seg(0xDB, bytes([1]) + bytes(
            q_chroma[ZIGZAG].astype(np.uint8)))
    out += seg(0xC0, struct.pack(">BHHB", 8, h, w, n) + b"".join(
        bytes([ci + 1, (samp[ci][0] << 4) | samp[ci][1], min(ci, 1)])
        for ci in range(n)))
    for tc, th, (counts, syms) in ((0, 0, _DC_LUMA), (1, 0, _AC_LUMA),
                                   (0, 1, _DC_CHROMA), (1, 1, _AC_CHROMA)):
        if th < n:
            out += seg(0xC4, bytes([(tc << 4) | th]) + counts + syms)
    out += seg(0xDA, bytes([n]) + b"".join(
        bytes([ci + 1, (min(ci, 1) << 4) | min(ci, 1)]) for ci in range(n))
        + bytes([0, 63, 0]))
    return out + _pack_bits(codes, lens) + b"\xff\xd9"


def write_jpeg(path: str, img: np.ndarray, quality: int = 90,
               subsampling: str = "4:2:0") -> None:
    with open(path, "wb") as fh:
        fh.write(encode_jpeg(img, quality, subsampling))
