"""The port's EXR codec (libyafaray_tpu_torch/io/exr.py, io/exr_codecs.py
and the Huffman coder io/cpp/exr_huf.cpp) against the JAX reference's
(libyafaray_tpu/io/exr.py, io/exr_codecs.py): every codec the reference
writes (NONE, ZIPS, PXR24, B44, B44A, PIZ), scanline and in 4x4 tiles,
written by both and read by both; the read-only codecs RLE and ZIP on
hand-built files; MIPMAP and RIPMAP tiled files; the wavelet and Huffman
units; and an .exr texture through load_image.

Every comparison is exact: the same file bytes from both writers, and
the same float32 bits from both readers (PXR24, B44 and B44A are lossy,
so their round trip is not the input; both packages lose the same
bits)."""
import struct
import zlib

import numpy as np
import pytest
import torch

from libyafaray_tpu.io import exr as ref_exr
from libyafaray_tpu.io import exr_codecs as ref_codecs
from libyafaray_tpu.io.image import load_image as ref_load_image
from libyafaray_tpu_torch.io import exr
from libyafaray_tpu_torch.io import exr_codecs as codecs
from libyafaray_tpu_torch.io.image import load_image


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """The port's CPU path is many small tensor ops: one thread runs them
    fastest (and keeps parallel test workers off each other's cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

CODECS = ["none", "zips", "pxr24", "b44", "b44a", "piz"]
LAYOUTS = {"scanline": None, "tiles4": (4, 4)}


def _layers(seed=5):
    """13 x 11 (ragged 4x4 tiles): an RGB layer with smooth and noisy
    parts, an alpha-like Y layer and a flat layer (B44A's flat blocks)."""
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:13, 0:11].astype(np.float32)
    smooth = np.stack([x / 11.0, y / 13.0, (x + y) / 24.0], axis=-1) * 3.0
    noise = rng.random((13, 11, 3), np.float32) * 0.2
    return {"": smooth + noise,
            "alpha": rng.random((13, 11), np.float32),
            "flat": np.full((13, 11, 3), 0.25, np.float32)}


def _assert_same_layers(got: dict, want: dict):
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == np.float32 and got[k].shape == want[k].shape
        assert np.array_equal(got[k].view(np.uint32),
                              want[k].view(np.uint32)), k


@pytest.mark.parametrize("layout", list(LAYOUTS))
@pytest.mark.parametrize("codec", CODECS)
def test_every_codec_both_ways(tmp_path, codec, layout):
    layers = _layers()
    tiles = LAYOUTS[layout]
    mine, ref = str(tmp_path / "port.exr"), str(tmp_path / "ref.exr")
    exr.write_exr_multilayer(mine, layers, codec, tiles=tiles)
    ref_exr.write_exr_multilayer(ref, layers, codec, tiles=tiles)
    with open(mine, "rb") as a, open(ref, "rb") as b:
        assert a.read() == b.read()
    # the port's read of the reference's file, the reference's of the port's
    want = ref_exr.read_exr_multilayer(ref)
    _assert_same_layers(exr.read_exr_multilayer(ref), want)
    _assert_same_layers(ref_exr.read_exr_multilayer(mine), want)
    if codec in ("none", "zips", "piz"):  # lossless on float32
        for k, v in layers.items():
            assert np.array_equal(want[k].reshape(v.shape), v), k


def _chlist(names):
    return b"".join(n.encode() + b"\0" + struct.pack("<iiii", 2, 0, 1, 1)
                    for n in sorted(names)) + b"\0"


def _header(w, h, comp, tiledesc=None):
    a = ref_exr._attr
    out = (a(b"channels", b"chlist", _chlist(["B", "G", "R"]))
           + a(b"compression", b"compression", bytes([comp]))
           + a(b"dataWindow", b"box2i", struct.pack("<iiii", 0, 0, w - 1,
                                                    h - 1))
           + a(b"displayWindow", b"box2i", struct.pack("<iiii", 0, 0, w - 1,
                                                       h - 1))
           + a(b"lineOrder", b"lineOrder", b"\0")
           + a(b"pixelAspectRatio", b"float", struct.pack("<f", 1.0))
           + a(b"screenWindowCenter", b"v2f", struct.pack("<ff", 0.0, 0.0))
           + a(b"screenWindowWidth", b"float", struct.pack("<f", 1.0)))
    if tiledesc is not None:
        out += a(b"tiles", b"tiledesc", struct.pack("<IIB", *tiledesc))
    return out + b"\0"


def _write_file(path, header, chunks, tiled=False):
    with open(path, "wb") as f:
        f.write(struct.pack("<II", 20000630, 2 | (0x200 if tiled else 0)))
        f.write(header)
        off = f.tell() + 8 * len(chunks)
        offs = []
        for c in chunks:
            offs.append(off)
            off += len(c)
        f.write(struct.pack(f"<{len(chunks)}Q", *offs))
        for c in chunks:
            f.write(c)


def _rle_encode(buf: bytes) -> bytes:
    """OpenEXR RLE: a run of r >= 3 equal bytes as (r - 1, byte), anything
    else as literal runs (-n, n bytes); runs of at most 127."""
    out, i, n = bytearray(), 0, len(buf)
    while i < n:
        r = 1
        while i + r < n and r < 127 and buf[i + r] == buf[i]:
            r += 1
        if r >= 3:
            out += bytes([r - 1, buf[i]])
            i += r
            continue
        j = i
        while j < n and j - i < 127 and not (
                j + 2 < n and buf[j] == buf[j + 1] == buf[j + 2]):
            j += 1
        out += np.int8(-(j - i)).tobytes() + buf[i:j]
        i = j
    return bytes(out)


@pytest.mark.parametrize("comp, lines", [(1, 1), (3, 16)],
                         ids=["rle", "zip16"])
def test_read_only_codecs_on_hand_built_files(tmp_path, comp, lines):
    """RLE (type 1, a scanline a chunk) and ZIP (type 3, 16 scanlines a
    chunk), which neither package writes: both read the same bits."""
    h, w = 37, 23
    rng = np.random.default_rng(8)
    img = rng.random((h, w, 3), np.float32)
    img[5:9] = 0.5  # long runs for the RLE
    chunks = []
    for y0 in range(0, h, lines):
        raw = b"".join(img[y, :, c].astype("<f4").tobytes()
                       for y in range(y0, min(y0 + lines, h))
                       for c in (2, 1, 0))  # B, G, R
        body = (_rle_encode(ref_exr._filter(raw)) if comp == 1
                else zlib.compress(ref_exr._filter(raw)))
        if len(body) >= len(raw):
            body = raw
        chunks.append(struct.pack("<ii", y0, len(body)) + body)
    path = str(tmp_path / "rw.exr")
    _write_file(path, _header(w, h, comp), chunks)
    want = ref_exr.read_exr(path)
    assert np.array_equal(want, img)
    got = exr.read_exr(path)
    assert np.array_equal(got.view(np.uint32), want.view(np.uint32))


@pytest.mark.parametrize("mode", [1, 2], ids=["mipmap", "ripmap"])
def test_mip_and_rip_levels_give_level_zero(tmp_path, mode):
    """Hand-built MIPMAP and RIPMAP tiled files (NONE, 4x4 tiles, round
    down) of a 9 x 6 image: both readers return level (0, 0) and step past
    every other level's tiles."""
    w, h = 9, 6
    rng = np.random.default_rng(12)
    lvl0 = rng.random((h, w, 3), np.float32)

    def n_levels(s):
        n = 1
        while s > 1:
            s >>= 1
            n += 1
        return n

    levels = ([(lv, lv) for lv in range(n_levels(max(w, h)))] if mode == 1
              else [(lx, ly) for ly in range(n_levels(h))
                    for lx in range(n_levels(w))])
    chunks = []
    for lx, ly in levels:
        lw, lh = max(1, w >> lx), max(1, h >> ly)
        arr = lvl0[:lh, :lw] if (lx, ly) == (0, 0) else np.full(
            (lh, lw, 3), 99.0 + lx + 10 * ly, np.float32)
        for ty in range(0, lh, 4):
            for tx in range(0, lw, 4):
                t = arr[ty:ty + 4, tx:tx + 4]
                body = b"".join(t[y, :, c].astype("<f4").tobytes()
                                for y in range(t.shape[0]) for c in (2, 1, 0))
                chunks.append(struct.pack("<iiiii", tx // 4, ty // 4, lx,
                                          ly, len(body)) + body)
    path = str(tmp_path / "mip.exr")
    _write_file(path, _header(w, h, 0, (4, 4, mode)), chunks, tiled=True)
    want = ref_exr.read_exr(path)
    assert np.array_equal(want, lvl0)
    assert np.array_equal(exr.read_exr(path), want)


def test_wavelet_and_huffman_units_match_reference():
    rng = np.random.default_rng(3)
    for shape in ((31, 17), (1, 9), (9, 1), (5, 5), (4, 8)):
        for mx in (100, 60000):
            a = rng.integers(0, min(mx + 1, 60000), shape).astype(np.uint16)
            mine, ref = a.copy(), a.copy()
            codecs.wav2_encode(mine, mx)
            ref_codecs.wav2_encode(ref, mx)
            assert np.array_equal(mine, ref), (shape, mx)
            codecs.wav2_decode(mine, mx)
            assert np.array_equal(mine, a), (shape, mx)
    for n, hi in ((1000, 40), (50000, 5000), (3, 1), (1, 1)):
        d = rng.integers(0, hi, n).astype(np.uint16)
        enc = codecs._huf_compress(d)
        assert enc == ref_codecs._huf_compress(d)
        assert np.array_equal(codecs._huf_decompress(enc, n), d)


def test_piz_without_the_huffman_coder_raises(monkeypatch):
    def no_gxx(*args):
        raise RuntimeError("g++ not found on PATH")

    monkeypatch.setattr(codecs._build, "load_host", no_gxx)
    with pytest.raises(NotImplementedError, match="Huffman"):
        codecs._huf_compress(np.zeros(4, np.uint16))


@pytest.mark.parametrize("codec, tiles", [("piz", (4, 4)), ("b44a", None)])
def test_exr_texture_through_load_image(tmp_path, codec, tiles):
    path = str(tmp_path / "tex.exr")
    img = _layers()[""]
    ref_exr.write_exr(path, img, codec) if tiles is None else \
        ref_exr.write_exr_multilayer(path, {"": img}, codec, tiles=tiles)
    got, want = load_image(path), ref_load_image(path)
    assert got.shape == want.shape == (13, 11, 3)
    assert np.array_equal(got.view(np.uint32), want.view(np.uint32))
