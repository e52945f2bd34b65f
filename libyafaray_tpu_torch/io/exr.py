"""Minimal OpenEXR codec (port of libyafaray_tpu/io/exr.py's scanline
subset): single-part scanline files of float32 channels, one layer a
channel-name prefix (`layer.R`, `layer.G`, ...; the combined image's
channels bare), as the reference's multilayer output writes all render
passes into one file.  Write: compression NONE or ZIPS, one scanline a
chunk (a ZIPS chunk that does not shrink is stored raw).  Read: NONE, ZIPS
and ZIP of float32 / half / uint channels.  Tiled and multi-part files and
the other codecs raise (ROADMAP Queue 1 item 22).  Pure numpy, struct and
zlib."""
from __future__ import annotations

import struct
import zlib

import numpy as np

_MAGIC = 20000630
_PIXEL_FLOAT = 2  # OpenEXR FLOAT
_SIZE = {0: 4, 1: 2, 2: 4}  # UINT, HALF, FLOAT bytes
_DT = {0: "<u4", 1: "<f2", 2: "<f4"}
_LINES = {0: 1, 2: 1, 3: 16}  # NONE, ZIPS, ZIP
_WRITE = {"none": 0, "zips": 2}
_UNPORTED = ("{} is not ported yet: ROADMAP Queue 1 item 22 (the rest of "
             "the EXR codec)")


def _unfilter(buf: bytes) -> bytes:
    """Undo the EXR zip byte filter: delta predictor, then re-interleave
    the two halves."""
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


def _attr(name: bytes, typ: bytes, data: bytes) -> bytes:
    return name + b"\0" + typ + b"\0" + struct.pack("<i", len(data)) + data


def write_exr(path: str, img: np.ndarray) -> None:
    """Write an (H, W, 3|4) image as a single-layer ZIPS EXR (channels R,
    G, B[, A]), as the reference's writer does."""
    write_exr_multilayer(path, {"": np.asarray(img, np.float32)})


def write_exr_multilayer(path: str, layers: dict,
                         compression: str = "zips") -> None:
    """layers: name -> (H, W, C) (channels R, G, B, A of the first C) or
    (H, W) (channel Y); the name "" writes bare channel names.  Every
    channel float32, alphabetical on disk, one scanline a chunk."""
    if compression not in _WRITE:
        raise NotImplementedError(_UNPORTED.format(
            f"EXR compression {compression!r}"))
    comp = _WRITE[compression]
    h, w = next(iter(layers.values())).shape[:2]
    planes = {}
    for lname, arr in layers.items():
        arr = np.asarray(arr, np.float32)
        comps = ["R", "G", "B", "A"][:arr.shape[-1]] if arr.ndim == 3 \
            else ["Y"]
        for ci, c in enumerate(comps):
            planes[f"{lname}.{c}" if lname else c] = (
                arr[..., ci] if arr.ndim == 3 else arr)
    names = sorted(planes)
    chlist = b"".join(n.encode() + b"\0" + struct.pack("<iiii", _PIXEL_FLOAT,
                                                       0, 1, 1)
                      for n in names) + b"\0"
    header = (
        _attr(b"channels", b"chlist", chlist)
        + _attr(b"compression", b"compression", bytes([comp]))
        + _attr(b"dataWindow", b"box2i", struct.pack("<iiii", 0, 0, w - 1,
                                                     h - 1))
        + _attr(b"displayWindow", b"box2i", struct.pack("<iiii", 0, 0,
                                                        w - 1, h - 1))
        + _attr(b"lineOrder", b"lineOrder", b"\0")  # INCREASING_Y
        + _attr(b"pixelAspectRatio", b"float", struct.pack("<f", 1.0))
        + _attr(b"screenWindowCenter", b"v2f", struct.pack("<ff", 0.0, 0.0))
        + _attr(b"screenWindowWidth", b"float", struct.pack("<f", 1.0))
        + b"\0")
    chunks = []
    for y in range(h):
        raw = b"".join(planes[n][y].astype("<f4").tobytes() for n in names)
        if comp == 2:
            z = zlib.compress(_filter(raw))
            raw = z if len(z) < len(raw) else raw
        chunks.append(struct.pack("<ii", y, len(raw)) + raw)
    with open(path, "wb") as f:
        f.write(struct.pack("<II", _MAGIC, 2))
        f.write(header)
        off = f.tell() + 8 * len(chunks)
        offsets = []
        for ch in chunks:
            offsets.append(off)
            off += len(ch)
        f.write(struct.pack(f"<{len(chunks)}Q", *offsets))
        for ch in chunks:
            f.write(ch)


def read_exr(path: str) -> np.ndarray:
    """The combined image of an EXR: its bare-named layer (channels R, G,
    B[, A]), else its first layer."""
    layers = read_exr_multilayer(path)
    if "" in layers:
        return layers[""]
    return next(iter(layers.values()))


def read_exr_multilayer(path: str) -> dict:
    """name -> layer of a single-part scanline EXR: (H, W, C) float32 of
    its R, G, B, A channels in that order, or (H, W) of its one other
    channel; the layer of a channel is its name before the last dot ("" for
    a bare name)."""
    with open(path, "rb") as f:
        data = f.read()
    magic, version = struct.unpack_from("<II", data, 0)
    if magic != _MAGIC:
        raise ValueError("not an EXR file")
    if version & 0x1000:
        raise NotImplementedError(_UNPORTED.format("multi-part EXR"))
    if version & 0x200:
        raise NotImplementedError(_UNPORTED.format("tiled EXR"))
    pos = 8
    channels = []
    h = w = None
    compression = 0
    while data[pos] != 0:
        name_end = data.index(b"\0", pos)
        name = data[pos:name_end].decode()
        type_end = data.index(b"\0", name_end + 1)
        (size,) = struct.unpack_from("<i", data, type_end + 1)
        payload = data[type_end + 5:type_end + 5 + size]
        pos = type_end + 5 + size
        if name == "channels":
            cpos = 0
            while payload[cpos] != 0:
                ce = payload.index(b"\0", cpos)
                ptype = struct.unpack_from("<i", payload, ce + 1)[0]
                channels.append((payload[cpos:ce].decode(), ptype))
                cpos = ce + 1 + 16
        elif name == "dataWindow":
            x0, y0, x1, y1 = struct.unpack("<iiii", payload)
            w, h = x1 - x0 + 1, y1 - y0 + 1
        elif name == "compression":
            compression = payload[0]
    pos += 1  # header terminator
    if compression not in _LINES:
        raise NotImplementedError(_UNPORTED.format(
            f"EXR compression type {compression}"))
    lines = _LINES[compression]
    chans = sorted(c for c, _ in channels)
    ptypes = dict(channels)
    planes = {c: np.zeros((h, w), np.float32) for c in chans}
    offsets = struct.unpack_from(f"<{-(-h // lines)}Q", data, pos)
    for off in offsets:
        y0, nbytes = struct.unpack_from("<ii", data, off)
        raw = data[off + 8:off + 8 + nbytes]
        bh = min(lines, h - y0)
        expect = sum(_SIZE[ptypes[c]] * w for c in chans) * bh
        if compression == 0 or len(raw) == expect:
            chunk = raw  # stored raw (did not compress smaller)
        else:
            chunk = _unfilter(zlib.decompress(raw))
        p = 0
        for ly in range(bh):
            for c in chans:
                planes[c][y0 + ly] = np.frombuffer(
                    chunk, _DT[ptypes[c]], w, p).astype(np.float32)
                p += _SIZE[ptypes[c]] * w
    groups: dict = {}
    for c in chans:
        lname, comp = c.rsplit(".", 1) if "." in c else ("", c)
        groups.setdefault(lname, {})[comp] = planes[c]
    layers = {}
    for lname, comps in groups.items():
        order = [comps[k] for k in ("R", "G", "B", "A") if k in comps]
        layers[lname] = (np.stack(order, axis=-1) if order
                         else next(iter(comps.values())))
    return layers
