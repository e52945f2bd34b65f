"""OpenEXR B44/B44A, PXR24 and PIZ codecs, both directions (port of
libyafaray_tpu/io/exr_codecs.py).

  * B44 / B44A: lossy 4x4-block HALF codec (ImfB44Compressor.cpp
    layout: 16-bit first pixel + 6-bit shift + 15 x 6-bit residuals =
    14 bytes a block; B44A adds 3-byte flat blocks).  Non-HALF channels
    ride raw, per the format.
  * PXR24: zlib over per-scanline byte planes of integer deltas (FLOAT
    rounded to 24 bits, lossy; HALF / UINT lossless).
  * PIZ: bitmap + forward LUT, 2D wavelet over 16-bit planes, canonical
    Huffman (ImfPizCompressor.cpp / ImfWav.cpp / ImfHuf.cpp formats).  The
    Huffman coder is C++ (io/cpp/exr_huf.cpp), built with g++ at first use
    into the package's _build/ directory (ops/_build.py `load_host`);
    without g++ PIZ raises NotImplementedError, as in the reference.

Numpy apart from the Huffman coder; the byte formats follow the published
OpenEXR sources.
"""
from __future__ import annotations

import ctypes
import logging
import os
import struct
import threading
import zlib

import numpy as np

from ..ops import _build

log = logging.getLogger("libyafaray_tpu_torch")

# ---------------------------------------------------------------------------
# B44 / B44A (ImfB44Compressor.cpp)
# ---------------------------------------------------------------------------


def _b44_to_t(h16: np.ndarray) -> np.ndarray:
    """Half bits -> monotonic unsigned ordering t (pack() transform)."""
    h = h16.astype(np.uint16)
    t = np.where((h & 0x7C00) == 0x7C00, np.uint16(0x8000),
                 np.where(h & 0x8000, ~h, h | 0x8000))
    return t.astype(np.uint16)


def _b44_from_t(t: np.ndarray) -> np.ndarray:
    t = t.astype(np.uint16)
    return np.where(t & 0x8000, t & 0x7FFF, ~t).astype(np.uint16)


def _shift_and_round(x: np.ndarray, shift) -> np.ndarray:
    """ImfB44Compressor shiftAndRound: round-to-nearest-even-ish halving."""
    x = x.astype(np.int64) << 1
    sh = shift + 1
    x = x + ((np.int64(1) << sh) >> 1)
    return x >> sh


# residual chain order used by pack()/unpack(): index pairs (prev, cur)
_B44_CHAIN = [(0, 4), (4, 8), (8, 12),
              (0, 1), (4, 5), (8, 9), (12, 13),
              (1, 2), (5, 6), (9, 10), (13, 14),
              (2, 3), (6, 7), (10, 11), (14, 15)]


def _b44_pack_blocks(t: np.ndarray, flat_ok: bool):
    """t: (NB, 16) uint16 -> list of per-block byte strings."""
    nb = t.shape[0]
    t64 = t.astype(np.int64)
    t_max = t64.max(axis=1)
    # find, per block, the smallest shift with all residuals in [-32, 31]
    shift = np.zeros(nb, np.int64)
    d = np.zeros((nb, 16), np.int64)
    pending = np.ones(nb, bool)
    for s in range(17):
        if not pending.any():
            break
        ds = _shift_and_round(t_max[:, None] - t64, s)
        r = np.stack([ds[:, a] - ds[:, b] for a, b in _B44_CHAIN], axis=1)
        ok = (r >= -0x20).all(axis=1) & (r <= 0x1F).all(axis=1)
        take = pending & ok
        shift[take] = s
        d[take] = ds[take]
        pending &= ~ok
    r = np.stack([d[:, a] - d[:, b] for a, b in _B44_CHAIN], axis=1)
    fields = np.concatenate([shift[:, None], r + 0x20], axis=1)  # (NB,16)
    # 16 six-bit fields -> 12 bytes (4 fields per 3 bytes)
    f = fields.reshape(nb, 4, 4).astype(np.uint32)
    packed = (f[..., 0] << 18) | (f[..., 1] << 12) | (f[..., 2] << 6) \
        | f[..., 3]
    payload = np.stack([(packed >> 16) & 0xFF, (packed >> 8) & 0xFF,
                        packed & 0xFF], axis=-1).reshape(nb, 12)
    head = np.stack([t[:, 0] >> 8, t[:, 0] & 0xFF], axis=1)
    blocks14 = np.concatenate([head, payload], axis=1).astype(np.uint8)
    if flat_ok:
        flat = (r == 0).all(axis=1)
        out = []
        for i in range(nb):
            if flat[i]:
                out.append(bytes([int(t[i, 0]) >> 8, int(t[i, 0]) & 0xFF,
                                  0xFC]))
            else:
                out.append(blocks14[i].tobytes())
        return out
    return [blocks14[i].tobytes() for i in range(nb)]


def _b44_unpack14(b: np.ndarray) -> np.ndarray:
    """b: (NB, 14) uint8 -> t (NB, 16) uint16."""
    nb = b.shape[0]
    b32 = b.astype(np.uint32)
    t0 = (b32[:, 0] << 8) | b32[:, 1]
    grp = b32[:, 2:].reshape(nb, 4, 3)
    packed = (grp[..., 0] << 16) | (grp[..., 1] << 8) | grp[..., 2]
    fields = np.stack([(packed >> 18) & 0x3F, (packed >> 12) & 0x3F,
                       (packed >> 6) & 0x3F, packed & 0x3F],
                      axis=-1).reshape(nb, 16)
    shift = fields[:, 0].astype(np.int64)
    r = fields[:, 1:].astype(np.int64)
    t = np.zeros((nb, 16), np.int64)
    t[:, 0] = t0
    bias = np.int64(0x20) << shift
    for k, (a, c) in enumerate(_B44_CHAIN):
        t[:, c] = t[:, a] + (r[:, k] << shift) - bias
    return (t & 0xFFFF).astype(np.uint16)


def _b44_channel_compress(plane16: np.ndarray, flat_ok: bool) -> bytes:
    """plane16: (ny, nx) uint16 halves -> compressed channel bytes."""
    ny, nx = plane16.shape
    py = (-ny) % 4
    px = (-nx) % 4
    p = np.pad(plane16, ((0, py), (0, px)), mode="edge")
    by, bx = p.shape[0] // 4, p.shape[1] // 4
    blocks = p.reshape(by, 4, bx, 4).transpose(0, 2, 1, 3).reshape(-1, 16)
    t = _b44_to_t(blocks)
    return b"".join(_b44_pack_blocks(t, flat_ok))


def _b44_channel_decompress(raw: bytes, pos: int, ny: int, nx: int):
    """-> (plane (ny, nx) uint16, new pos).  Handles 3-byte flat blocks."""
    by, bx = -(-ny // 4), -(-nx // 4)
    nb = by * bx
    t = np.zeros((nb, 16), np.uint16)
    # scan: variable-length (flat marker = third byte 0xfc when shift
    # field is 0x3f).  Collect 14-byte block indices for one vectorized
    # unpack pass.
    idx14 = []
    buf14 = []
    for i in range(nb):
        b2 = raw[pos + 2]
        if b2 >= 0xFC:  # flat block (B44A)
            v = (raw[pos] << 8) | raw[pos + 1]
            t[i] = v
            pos += 3
        else:
            idx14.append(i)
            buf14.append(raw[pos:pos + 14])
            pos += 14
    if idx14:
        arr = np.frombuffer(b"".join(buf14), np.uint8).reshape(-1, 14)
        t[np.asarray(idx14)] = _b44_unpack14(arr)
    h = _b44_from_t(t)
    plane = h.reshape(by, bx, 4, 4).transpose(0, 2, 1, 3).reshape(by * 4,
                                                                  bx * 4)
    return plane[:ny, :nx], pos


def b44_compress_chunk(chan_planes, ptypes, flat_ok: bool) -> bytes:
    """chan_planes: [(name, (ny, nx) array raw-typed)] in channel order.
    HALF planes are uint16 half-bits; others raw bytes (stored as-is)."""
    out = []
    for name, plane in chan_planes:
        if ptypes[name] == 1:  # HALF
            out.append(_b44_channel_compress(plane, flat_ok))
        else:
            out.append(plane.tobytes())
    return b"".join(out)


def b44_decompress_chunk(raw: bytes, chans, ptypes, w: int,
                         n_lines: int) -> bytes:
    """-> standard interleaved chunk layout (per line, per channel)."""
    planes = {}
    pos = 0
    for c in chans:
        if ptypes[c] == 1:
            planes[c], pos = _b44_channel_decompress(raw, pos, n_lines, w)
        else:
            sz = {0: 4, 2: 4}[ptypes[c]] * w * n_lines
            planes[c] = np.frombuffer(raw, np.uint8, sz, pos).reshape(
                n_lines, -1)
            pos += sz
    lines = []
    for ly in range(n_lines):
        for c in chans:
            if ptypes[c] == 1:
                lines.append(planes[c][ly].astype("<u2").tobytes())
            else:
                lines.append(planes[c][ly].tobytes())
    return b"".join(lines)


# ---------------------------------------------------------------------------
# PXR24 (ImfPxr24Compressor.cpp)
# ---------------------------------------------------------------------------


def _float_to_float24(f32_bits: np.ndarray) -> np.ndarray:
    """Round float32 bit patterns to 24-bit (drop 8 mantissa LSBs,
    round to nearest; inf/nan preserved)."""
    i = f32_bits.astype(np.uint32)
    special = (i & 0x7F800000) == 0x7F800000
    rounded = ((i.astype(np.uint64) + 0x80) >> 8).astype(np.uint32)
    # rounding must not carry into inf
    sign = i & 0x80000000
    max24 = ((sign | 0x7F7FFFFF) >> 8).astype(np.uint32)
    became_inf = ~special & (((rounded << 8) & 0x7F800000) == 0x7F800000)
    rounded = np.where(became_inf, max24, rounded)
    # NaN must stay NaN after truncation (mantissa must not become 0)
    is_nan = special & ((i & 0x007FFFFF) != 0)
    sp = (i >> 8) | is_nan.astype(np.uint32)
    return np.where(special, sp, rounded) & 0xFFFFFF


def pxr24_compress_chunk(chan_lines, ptypes) -> bytes:
    """chan_lines: per scanline, list of (name, line_array) — FLOAT lines
    are float32, HALF uint16, UINT uint32."""
    parts = []
    for name, line in chan_lines:
        pt = ptypes[name]
        if pt == 2:  # FLOAT -> 24 bit deltas in 3 byte planes
            v = _float_to_float24(line.view(np.uint32)).astype(np.int64)
            d = np.diff(v, prepend=0) & 0xFFFFFF
            parts.append(((d >> 16) & 0xFF).astype(np.uint8).tobytes())
            parts.append(((d >> 8) & 0xFF).astype(np.uint8).tobytes())
            parts.append((d & 0xFF).astype(np.uint8).tobytes())
        elif pt == 1:  # HALF: 16-bit deltas, 2 planes
            v = line.astype(np.int64)
            d = np.diff(v, prepend=0) & 0xFFFF
            parts.append(((d >> 8) & 0xFF).astype(np.uint8).tobytes())
            parts.append((d & 0xFF).astype(np.uint8).tobytes())
        else:  # UINT: 32-bit deltas, 4 planes
            v = line.astype(np.int64)
            d = np.diff(v, prepend=0) & 0xFFFFFFFF
            for sh in (24, 16, 8, 0):
                parts.append(((d >> sh) & 0xFF).astype(np.uint8).tobytes())
    return zlib.compress(b"".join(parts))


def pxr24_decompress_chunk(raw: bytes, chans, ptypes, w: int,
                           n_lines: int) -> bytes:
    """-> interleaved chunk with FLOAT expanded back to float32 bits."""
    buf = zlib.decompress(raw)
    pos = 0
    lines = []
    for ly in range(n_lines):
        for c in chans:
            pt = ptypes[c]
            if pt == 2:
                p0 = np.frombuffer(buf, np.uint8, w, pos)
                p1 = np.frombuffer(buf, np.uint8, w, pos + w)
                p2 = np.frombuffer(buf, np.uint8, w, pos + 2 * w)
                pos += 3 * w
                d = ((p0.astype(np.int64) << 16)
                     | (p1.astype(np.int64) << 8) | p2)
                v = (np.cumsum(d) & 0xFFFFFF).astype(np.uint32) << 8
                lines.append(v.astype("<u4").tobytes())
            elif pt == 1:
                p0 = np.frombuffer(buf, np.uint8, w, pos)
                p1 = np.frombuffer(buf, np.uint8, w, pos + w)
                pos += 2 * w
                d = (p0.astype(np.int64) << 8) | p1
                v = (np.cumsum(d) & 0xFFFF).astype(np.uint16)
                lines.append(v.astype("<u2").tobytes())
            else:
                ps = [np.frombuffer(buf, np.uint8, w, pos + k * w)
                      for k in range(4)]
                pos += 4 * w
                d = ((ps[0].astype(np.int64) << 24)
                     | (ps[1].astype(np.int64) << 16)
                     | (ps[2].astype(np.int64) << 8) | ps[3])
                v = (np.cumsum(d) & 0xFFFFFFFF).astype(np.uint32)
                lines.append(v.astype("<u4").tobytes())
    return b"".join(lines)


# ---------------------------------------------------------------------------
# PIZ (ImfPizCompressor.cpp + ImfWav.cpp; Huffman via io/cpp/exr_huf.cpp)
# ---------------------------------------------------------------------------

_BITMAP_SIZE = 8192  # 65536 bits


def _bitmap_from_data(data: np.ndarray):
    """-> (bitmap uint8 (8192,), minNonZero, maxNonZero).  The bit for
    value 0 is never stored (lut maps 0 -> 0 implicitly)."""
    used = np.zeros(65536, bool)
    used[np.unique(data)] = True
    used[0] = False
    bitmap = np.packbits(used.reshape(-1, 8)[:, ::-1], axis=1,
                         bitorder="big")[:, 0]
    # packbits with reversed nibble == little-endian bit order per byte
    nz = np.nonzero(bitmap)[0]
    if len(nz) == 0:
        return bitmap, _BITMAP_SIZE - 1, 0
    return bitmap, int(nz[0]), int(nz[-1])


def _forward_lut(bitmap: np.ndarray):
    bits = np.unpackbits(bitmap[:, None], axis=1,
                         bitorder="little").reshape(-1).astype(bool)
    bits[0] = True  # value 0 always mapped (to 0)
    lut = np.zeros(65536, np.uint16)
    idx = np.nonzero(bits)[0]
    lut[idx] = np.arange(len(idx), dtype=np.uint16)
    max_value = len(idx) - 1
    return lut, max_value


def _reverse_lut(bitmap: np.ndarray):
    bits = np.unpackbits(bitmap[:, None], axis=1,
                         bitorder="little").reshape(-1).astype(bool)
    bits[0] = True
    idx = np.nonzero(bits)[0].astype(np.uint16)
    max_value = len(idx) - 1
    return idx, max_value


def _wenc14(a, b):
    as_ = a.astype(np.int16).astype(np.int32)
    bs = b.astype(np.int16).astype(np.int32)
    m = (as_ + bs) >> 1
    d = as_ - bs
    return (m & 0xFFFF).astype(np.uint16), (d & 0xFFFF).astype(np.uint16)


def _wdec14(l, h):
    ls = l.astype(np.int16).astype(np.int32)
    hs = h.astype(np.int16).astype(np.int32)
    ai = ls + (hs & 1) + (hs >> 1)
    a = ai
    b = ai - hs
    return (a & 0xFFFF).astype(np.uint16), (b & 0xFFFF).astype(np.uint16)


_A_OFFSET = 1 << 15
_MOD_MASK = (1 << 16) - 1


def _wenc16(a, b):
    ao = (a.astype(np.int64) + _A_OFFSET) & _MOD_MASK
    bi = b.astype(np.int64)
    m = (ao + bi) >> 1
    d = ao - bi
    m = np.where(d < 0, (m + _A_OFFSET) & _MOD_MASK, m)
    d &= _MOD_MASK
    return m.astype(np.uint16), d.astype(np.uint16)


def _wdec16(l, h):
    m = l.astype(np.int64)
    d = h.astype(np.int64)
    bb = (m - (d >> 1)) & _MOD_MASK
    aa = (d + bb - _A_OFFSET) & _MOD_MASK
    return aa.astype(np.uint16), bb.astype(np.uint16)


def _wav2_levels(nx, ny):
    n = min(nx, ny)
    levels = []
    p, p2 = 1, 2
    while p2 <= n:
        levels.append((p, p2))
        p, p2 = p2, p2 * 2
    return levels


def _wav2_apply(a: np.ndarray, p: int, p2: int, enc_pair, odd_pair,
                decode: bool):
    """One wav2 level over a (ny, nx) uint16 array, mirroring ImfWav.cpp's
    pointer traversal (quads + odd-column vertical + odd-row horizontal)."""
    ny, nx = a.shape
    rows = np.arange(0, ny - p2 + 1, p2) if ny >= p2 else np.zeros(0, int)
    cols = np.arange(0, nx - p2 + 1, p2) if nx >= p2 else np.zeros(0, int)
    r_after = (len(rows)) * p2
    c_after = (len(cols)) * p2
    if len(rows) and len(cols):
        rr, cc = np.meshgrid(rows, cols, indexing="ij")
        i00 = a[rr, cc]
        i01 = a[rr, cc + p]
        i10 = a[rr + p, cc]
        i11 = a[rr + p, cc + p]
        if not decode:
            t00, t01 = enc_pair(i00, i01)
            t10, t11 = enc_pair(i10, i11)
            o00, o10 = enc_pair(t00, t10)
            o01, o11 = enc_pair(t01, t11)
        else:
            t00, t10 = enc_pair(i00, i10)
            t01, t11 = enc_pair(i01, i11)
            o00, o01 = enc_pair(t00, t01)
            o10, o11 = enc_pair(t10, t11)
        a[rr, cc] = o00
        a[rr, cc + p] = o01
        a[rr + p, cc] = o10
        a[rr + p, cc + p] = o11
    if (nx & p) and len(rows):  # odd column: vertical pair at c_after
        v0, v1 = odd_pair(a[rows, c_after], a[rows + p, c_after])
        a[rows, c_after] = v0
        a[rows + p, c_after] = v1
    if (ny & p) and len(cols):  # odd row: horizontal pair at r_after
        h0, h1 = odd_pair(a[r_after, cols], a[r_after, cols + p])
        a[r_after, cols] = h0
        a[r_after, cols + p] = h1


def wav2_encode(a: np.ndarray, max_value: int) -> None:
    enc = _wenc14 if max_value < (1 << 14) else _wenc16
    for p, p2 in _wav2_levels(a.shape[1], a.shape[0]):
        _wav2_apply(a, p, p2, enc, enc, decode=False)


def wav2_decode(a: np.ndarray, max_value: int) -> None:
    dec = _wdec14 if max_value < (1 << 14) else _wdec16
    for p, p2 in reversed(_wav2_levels(a.shape[1], a.shape[0])):
        _wav2_apply(a, p, p2, dec, dec, decode=True)


# ---- native Huffman loader ------------------------------------------------

_HUF_SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "cpp",
                        "exr_huf.cpp")
_HUF_SIGNATURES = {
    "lyt_huf_compress": (ctypes.c_long, [
        ctypes.POINTER(ctypes.c_uint16), ctypes.c_long,
        ctypes.POINTER(ctypes.c_uint8), ctypes.c_long]),
    "lyt_huf_decompress": (ctypes.c_int, [
        ctypes.POINTER(ctypes.c_uint8), ctypes.c_long,
        ctypes.POINTER(ctypes.c_uint16), ctypes.c_long])}


def _load_huf():
    try:
        return _build.load_host(_HUF_SRC, _HUF_SIGNATURES)
    except Exception as e:  # noqa: BLE001 — PIZ cannot run without it
        raise NotImplementedError(
            f"PIZ needs the native Huffman helper ({e})") from e


def _huf_compress(data: np.ndarray) -> bytes:
    lib = _load_huf()
    data = np.ascontiguousarray(data, np.uint16)
    cap = 20 + 2 * data.size + 65536
    out = np.empty(cap, np.uint8)
    nb = lib.lyt_huf_compress(
        data.ctypes.data_as(ctypes.POINTER(ctypes.c_uint16)), data.size,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), cap)
    if nb < 0:
        raise RuntimeError("huf compress overflow")
    return out[:nb].tobytes()


def _huf_decompress(raw: bytes, n: int) -> np.ndarray:
    lib = _load_huf()
    src = np.frombuffer(raw, np.uint8)
    out = np.empty(n, np.uint16)
    rc = lib.lyt_huf_decompress(
        src.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), src.size,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint16)), n)
    if rc != 0:
        raise ValueError(f"PIZ Huffman decode failed (rc={rc})")
    return out


# ---- PIZ chunk framing -----------------------------------------------------


def _piz_channel_shape(ptype, w, n_lines):
    """PIZ views each channel as shorts: HALF = 1 short/pixel,
    FLOAT/UINT = 2 shorts/pixel (nx doubled)."""
    size = 1 if ptype == 1 else 2
    return n_lines, w * size


def piz_compress_chunk(chan_planes, ptypes) -> bytes:
    """chan_planes: [(name, (ny, nx) plane)] raw-typed per channel:
    HALF planes uint16, FLOAT/UINT planes uint32 (viewed as 2 shorts)."""
    shorts = []
    for name, plane in chan_planes:
        if ptypes[name] == 1:
            s = np.ascontiguousarray(plane, np.uint16)
        else:
            s = np.ascontiguousarray(plane).view("<u2").reshape(
                plane.shape[0], -1)
        shorts.append(s.copy())
    all_vals = np.concatenate([s.reshape(-1) for s in shorts])
    bitmap, mn, mx = _bitmap_from_data(all_vals)
    lut, max_value = _forward_lut(bitmap)
    out = [struct.pack("<HH", mn, mx)]
    if mn <= mx:
        out.append(bitmap[mn:mx + 1].tobytes())
    pieces = []
    for s in shorts:
        m = lut[s]
        wav2_encode(m, max_value)
        pieces.append(m.reshape(-1))
    huf = _huf_compress(np.concatenate(pieces))
    out.append(struct.pack("<i", len(huf)))
    out.append(huf)
    return b"".join(out)


def piz_decompress_chunk(raw: bytes, chans, ptypes, w: int,
                         n_lines: int) -> bytes:
    mn, mx = struct.unpack_from("<HH", raw, 0)
    pos = 4
    bitmap = np.zeros(_BITMAP_SIZE, np.uint8)
    if mn <= mx:
        nbyt = mx - mn + 1
        bitmap[mn:mx + 1] = np.frombuffer(raw, np.uint8, nbyt, pos)
        pos += nbyt
    rlut, max_value = _reverse_lut(bitmap)
    (hlen,) = struct.unpack_from("<i", raw, pos)
    pos += 4
    shapes = [(c, _piz_channel_shape(ptypes[c], w, n_lines))
              for c in chans]
    total = sum(ny * nx for _, (ny, nx) in shapes)
    data = _huf_decompress(raw[pos:pos + hlen], total)
    planes = {}
    off = 0
    for c, (ny, nx) in shapes:
        m = data[off:off + ny * nx].reshape(ny, nx).copy()
        off += ny * nx
        wav2_decode(m, max_value)
        planes[c] = rlut[np.minimum(m, len(rlut) - 1)]
    lines = []
    for ly in range(n_lines):
        for c in chans:
            lines.append(planes[c][ly].astype("<u2").tobytes())
    return b"".join(lines)
