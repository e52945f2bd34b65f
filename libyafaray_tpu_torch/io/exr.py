"""Minimal OpenEXR 2.0 codec (port of libyafaray_tpu/io/exr.py): single-
part files, one layer a channel-name prefix (`layer.R`, `layer.G`, ...;
the combined image's channels bare), as the reference's multilayer output
writes all render passes into one file.

  * write: float32 (half for B44 / B44A), compression NONE / ZIPS / PXR24
    / B44 / B44A / PIZ, channels alphabetical on disk; scanline, or
    single-level tiled (`tiles=(xs, ys)`).  A ZIPS chunk that does not
    shrink is stored raw.
  * read: float32 / half / uint channels; compression NONE, RLE, ZIPS,
    ZIP, PIZ, PXR24, B44 and B44A (io/exr_codecs.py).  Tiled single-part
    files (version flag 0x200): ONE_LEVEL in full, level (0, 0) of MIPMAP
    and RIPMAP files (stepping past the whole offset table).

DWAA / DWAB and multi-part files raise NotImplementedError, as in the
reference.  Numpy, struct and zlib; PIZ's Huffman coder is C++ built with
g++ at first use.
"""
from __future__ import annotations

import struct
import zlib

import numpy as np

_MAGIC = 20000630
_PIXEL_FLOAT = 2  # OpenEXR FLOAT


def _attr(name: bytes, typ: bytes, data: bytes) -> bytes:
    return name + b"\0" + typ + b"\0" + struct.pack("<i", len(data)) + data


def _unfilter(buf: bytes) -> bytes:
    """Undo the EXR zip/rle byte filter: delta predictor, then re-interleave
    the two halves (ImfZip.cpp uncompress order)."""
    d = np.frombuffer(buf, np.uint8).astype(np.int64)
    n = d.shape[0]
    rec = ((np.cumsum(d) - 128 * np.arange(n)) % 256).astype(np.uint8)
    half = (n + 1) // 2
    out = np.empty(n, np.uint8)
    out[0::2] = rec[:half]
    out[1::2] = rec[half:]
    return out.tobytes()


def _filter(buf: bytes) -> bytes:
    """EXR zip byte filter (compress side): de-interleave, then delta."""
    d = np.frombuffer(buf, np.uint8)
    n = d.shape[0]
    half = (n + 1) // 2
    tmp = np.empty(n, np.uint8)
    tmp[:half] = d[0::2]
    tmp[half:] = d[1::2]
    t = tmp.astype(np.int64)
    out = np.empty(n, np.int64)
    out[0] = t[0]
    out[1:] = t[1:] - t[:-1] + 128
    return (out % 256).astype(np.uint8).tobytes()


def _rle_decode(raw: bytes, expect: int) -> bytes:
    src = np.frombuffer(raw, np.int8)
    out = bytearray()
    i, n = 0, len(raw)
    while i < n and len(out) < expect:
        c = int(src[i])
        i += 1
        if c < 0:  # literal run of -c bytes
            out += raw[i:i - c]
            i -= c
        else:  # replicate next byte c+1 times
            out += raw[i:i + 1] * (c + 1)
            i += 1
    return bytes(out)


def _channel_list(names, ptype=_PIXEL_FLOAT):
    out = b""
    for n in sorted(names):
        out += n.encode() + b"\0" + struct.pack("<iiii", ptype, 0, 1, 1)
    return out + b"\0"


def write_exr(path: str, img: np.ndarray, compression: str = "zips"):
    """Write an (H, W, 3|4) image as a single-layer EXR (channels R, G,
    B[, A]), ZIPS unless asked otherwise."""
    write_exr_multilayer(path, {"": np.asarray(img, np.float32)},
                         compression)


def _encode_block(chan_data, sorted_names, comp_id, ptype,
                  x0: int, y0: int, bw: int, bh: int) -> bytes:
    """Compress one rectangular block (a scanline chunk or one tile).
    Channel scanlines are interleaved per row in alphabetical channel
    order, exactly as ImfTiledOutputFile/ImfOutputFile lay them out."""
    if comp_id in (6, 7):  # B44/B44A: per-channel half planes
        from .exr_codecs import b44_compress_chunk

        planes = [(cn, np.asarray(chan_data[cn][y0:y0 + bh, x0:x0 + bw],
                                  np.float32).astype("<f2")
                   .view(np.uint16))
                  for cn in sorted_names]
        ptypes = {cn: ptype for cn in sorted_names}
        return b44_compress_chunk(planes, ptypes, flat_ok=(comp_id == 7))
    if comp_id == 5:  # PXR24
        from .exr_codecs import pxr24_compress_chunk

        chan_lines = [(cn, np.asarray(chan_data[cn][y, x0:x0 + bw], "<f4"))
                      for y in range(y0, y0 + bh)
                      for cn in sorted_names]
        ptypes = {cn: ptype for cn in sorted_names}
        return pxr24_compress_chunk(chan_lines, ptypes)
    if comp_id == 4:  # PIZ
        from .exr_codecs import piz_compress_chunk

        planes = [(cn, np.ascontiguousarray(
                       np.asarray(chan_data[cn][y0:y0 + bh, x0:x0 + bw],
                                  "<f4")).view(np.uint32))
                  for cn in sorted_names]
        ptypes = {cn: ptype for cn in sorted_names}
        return piz_compress_chunk(planes, ptypes)
    raw = b"".join(chan_data[cn][y, x0:x0 + bw].astype("<f4").tobytes()
                   for y in range(y0, y0 + bh)
                   for cn in sorted_names)
    if comp_id in (2, 3):
        z = zlib.compress(_filter(raw))
        return z if len(z) < len(raw) else raw
    return raw


def write_exr_multilayer(path: str, layers: dict,
                         compression: str = "zips", tiles=None):
    """layers: name -> (H, W, C) (channels R, G, B, A of the first C) or
    (H, W) (channel Y); the name "" writes bare channel names.  tiles=(xs,
    ys) writes single-level tiles of that size instead of scanlines."""
    comp_id = {"none": 0, "zips": 2, "piz": 4, "pxr24": 5,
               "b44": 6, "b44a": 7}[compression]
    # b44 compresses HALF data only — write half channels for it
    half = comp_id in (6, 7)
    ptype = 1 if half else _PIXEL_FLOAT
    h, w = next(iter(layers.values())).shape[:2]
    chan_names = []
    chan_data = {}
    for lname, arr in layers.items():
        arr = np.asarray(arr, np.float32)
        comps = ["R", "G", "B", "A"][: arr.shape[-1]] if arr.ndim == 3 else ["Y"]
        for ci, c in enumerate(comps):
            full = f"{lname}.{c}" if lname else c
            chan_names.append(full)
            chan_data[full] = arr[..., ci] if arr.ndim == 3 else arr

    header = b""
    header += _attr(b"channels", b"chlist", _channel_list(chan_names,
                                                          ptype))
    header += _attr(b"compression", b"compression", bytes([comp_id]))
    header += _attr(b"dataWindow", b"box2i",
                    struct.pack("<iiii", 0, 0, w - 1, h - 1))
    header += _attr(b"displayWindow", b"box2i",
                    struct.pack("<iiii", 0, 0, w - 1, h - 1))
    header += _attr(b"lineOrder", b"lineOrder", b"\0")  # INCREASING_Y
    header += _attr(b"pixelAspectRatio", b"float", struct.pack("<f", 1.0))
    header += _attr(b"screenWindowCenter", b"v2f",
                    struct.pack("<ff", 0.0, 0.0))
    header += _attr(b"screenWindowWidth", b"float", struct.pack("<f", 1.0))
    if tiles is not None:
        # tiledesc: xSize, ySize, mode byte (ONE_LEVEL=0, ROUND_DOWN=0)
        header += _attr(b"tiles", b"tiledesc",
                        struct.pack("<IIB", tiles[0], tiles[1], 0))
    header += b"\0"  # end of header

    sorted_names = sorted(chan_names)
    version = 2 | (0x200 if tiles is not None else 0)
    chunks = []
    if tiles is not None:
        txs, tys = tiles
        for ty0 in range(0, h, tys):
            for tx0 in range(0, w, txs):
                bw, bh = min(txs, w - tx0), min(tys, h - ty0)
                body = _encode_block(chan_data, sorted_names, comp_id,
                                     ptype, tx0, ty0, bw, bh)
                # tile chunk: dx, dy, levelX, levelY, dataSize, data
                chunks.append(struct.pack("<iiiii", tx0 // txs, ty0 // tys,
                                          0, 0, len(body)) + body)
    else:
        lines_per_chunk = {0: 1, 2: 1, 4: 32, 5: 16, 6: 32, 7: 32}[comp_id]
        for y0 in range(0, h, lines_per_chunk):
            nl = min(lines_per_chunk, h - y0)
            body = _encode_block(chan_data, sorted_names, comp_id, ptype,
                                 0, y0, w, nl)
            chunks.append(struct.pack("<ii", y0, len(body)) + body)
    with open(path, "wb") as f:
        f.write(struct.pack("<I", _MAGIC))
        f.write(struct.pack("<I", version))
        f.write(header)
        offset_table_pos = f.tell()
        data_start = offset_table_pos + 8 * len(chunks)
        offsets = []
        off = data_start
        for c in chunks:
            offsets.append(off)
            off += len(c)
        f.write(struct.pack(f"<{len(chunks)}Q", *offsets))
        for c in chunks:
            f.write(c)


def read_exr(path: str) -> np.ndarray:
    """The combined image of an EXR: its bare-named layer (channels R, G,
    B[, A]), else its first layer."""
    layers = read_exr_multilayer(path)
    if "" in layers:
        return layers[""]
    return next(iter(layers.values()))


def _n_levels(s: int, rnd: int) -> int:
    n, x = 1, s
    while x > 1:
        x = (x + (1 if rnd else 0)) >> 1
        n += 1
    return n


def _level_size(s: int, lev: int, rnd: int) -> int:
    b = 1 << lev
    sz = s // b
    if rnd == 1 and sz * b < s:
        sz += 1
    return max(1, sz)


def read_exr_multilayer(path: str) -> dict:
    """name -> layer of a single-part EXR: (H, W, C) float32 of its R, G,
    B, A channels in that order, or (H, W) of its one other channel; the
    layer of a channel is its name before the last dot ("" for a bare
    name)."""
    with open(path, "rb") as f:
        data = f.read()
    magic, version = struct.unpack_from("<II", data, 0)
    if magic != _MAGIC:
        raise ValueError("not an EXR file")
    if version & 0x1000:
        raise NotImplementedError("multi-part EXR files are not supported "
                                  "(the reference raises on them too)")
    tiled = bool(version & 0x200)
    pos = 8
    channels = []
    h = w = None
    compression = 0
    tile_desc = None
    while data[pos] != 0:
        name_end = data.index(b"\0", pos)
        name = data[pos:name_end].decode()
        pos = name_end + 1
        type_end = data.index(b"\0", pos)
        typ = data[pos:type_end].decode()
        pos = type_end + 1
        (size,) = struct.unpack_from("<i", data, pos)
        pos += 4
        payload = data[pos:pos + size]
        pos += size
        if name == "channels":
            cpos = 0
            while payload[cpos] != 0:
                ce = payload.index(b"\0", cpos)
                cname = payload[cpos:ce].decode()
                ptype = struct.unpack_from("<i", payload, ce + 1)[0]
                channels.append((cname, ptype))
                cpos = ce + 1 + 16
        elif name == "dataWindow":
            x0, y0, x1, y1 = struct.unpack("<iiii", payload)
            w, h = x1 - x0 + 1, y1 - y0 + 1
        elif name == "compression":
            compression = payload[0]
        elif name == "tiles":
            txs, tys, mode = struct.unpack_from("<IIB", payload)
            tile_desc = (txs, tys, mode & 0xF, mode >> 4)
    pos += 1  # header terminator
    lines_per_chunk = {0: 1, 1: 1, 2: 1, 3: 16, 4: 32, 5: 16,
                       6: 32, 7: 32}.get(compression)
    if lines_per_chunk is None:
        raise NotImplementedError(
            f"EXR compression type {compression} (DWAA/DWAB) is not "
            "supported (the reference raises on it too)")
    chans = sorted(c for c, _ in channels)
    ptypes = dict(channels)
    _size = {0: 4, 1: 2, 2: 4}  # UINT, HALF, FLOAT bytes
    _dt = {0: "<u4", 1: "<f2", 2: "<f4"}
    planes = {c: np.zeros((h, w), np.float32) for c in chans}

    def decode(raw, bw, bh):
        """Decompress one block (scanline chunk or tile) of bh rows of
        bw pixels; channel rows interleaved in alphabetical order."""
        expect = sum(_size[ptypes[c]] * bw for c in chans) * bh
        if compression == 0 or len(raw) == expect:
            return raw  # NONE, or stored raw (didn't compress smaller)
        if compression in (2, 3):  # ZIPS / ZIP
            return _unfilter(zlib.decompress(raw))
        if compression == 1:  # RLE
            return _unfilter(_rle_decode(raw, expect))
        if compression == 4:  # PIZ
            from .exr_codecs import piz_decompress_chunk

            return piz_decompress_chunk(raw, chans, ptypes, bw, bh)
        if compression == 5:  # PXR24
            from .exr_codecs import pxr24_decompress_chunk

            return pxr24_decompress_chunk(raw, chans, ptypes, bw, bh)
        from .exr_codecs import b44_decompress_chunk  # B44 / B44A

        return b44_decompress_chunk(raw, chans, ptypes, bw, bh)

    def blit(chunk, x0, y0, bw, bh):
        p = 0
        for ly in range(bh):
            for c in chans:
                planes[c][y0 + ly, x0:x0 + bw] = np.frombuffer(
                    chunk, _dt[ptypes[c]], bw, p).astype(np.float32)
                p += _size[ptypes[c]] * bw

    if tiled:
        if tile_desc is None:
            raise ValueError("tiled EXR without a tiles attribute")
        txs, tys, lmode, rnd = tile_desc
        # offset-table length depends on the level structure; we only
        # blit level (0, 0) tiles (full resolution) but must step past
        # the full table (ImfTileOffsets layout: RIPMAP iterates ly
        # outer / lx inner, tiles row-major within a level).
        if lmode == 0:  # ONE_LEVEL
            n_off = (-(-w // txs)) * (-(-h // tys))
        elif lmode == 1:  # MIPMAP
            n_off = sum((-(-_level_size(w, l, rnd) // txs)) *
                        (-(-_level_size(h, l, rnd) // tys))
                        for l in range(_n_levels(max(w, h), rnd)))
        else:  # RIPMAP
            n_off = sum((-(-_level_size(w, lx, rnd) // txs)) *
                        (-(-_level_size(h, ly, rnd) // tys))
                        for ly in range(_n_levels(h, rnd))
                        for lx in range(_n_levels(w, rnd)))
        offsets = struct.unpack_from(f"<{n_off}Q", data, pos)
        for off in offsets:
            dx, dy, lx, ly, nbytes = struct.unpack_from("<iiiii", data, off)
            if lx != 0 or ly != 0:
                continue  # mip/rip level — renderer wants full res only
            x0, y0 = dx * txs, dy * tys
            bw, bh = min(txs, w - x0), min(tys, h - y0)
            raw = data[off + 20:off + 20 + nbytes]
            blit(decode(raw, bw, bh), x0, y0, bw, bh)
    else:
        n_chunks = -(-h // lines_per_chunk)
        offsets = struct.unpack_from(f"<{n_chunks}Q", data, pos)
        for off in offsets:
            y0, nbytes = struct.unpack_from("<ii", data, off)
            raw = data[off + 8:off + 8 + nbytes]
            n_lines = min(lines_per_chunk, h - y0)
            blit(decode(raw, w, n_lines), 0, y0, w, n_lines)
    # group channels into layers
    layers: dict = {}
    groups: dict = {}
    for c in chans:
        if "." in c:
            lname, comp = c.rsplit(".", 1)
        else:
            lname, comp = "", c
        groups.setdefault(lname, {})[comp] = planes[c]
    for lname, comps in groups.items():
        order = [comps[k] for k in ("R", "G", "B", "A") if k in comps]
        if order:
            layers[lname] = np.stack(order, axis=-1)
        else:
            layers[lname] = next(iter(comps.values()))
    return layers
