"""Image I/O (port of libyafaray_tpu/io/image.py `load_image`,
`save_image` and `save_multilayer_exr`).

Loads decode to LINEAR float32 (H, W, 3[4]): .hdr through io/rgbe.py, .exr
through io/exr.py, PNG through `read_png` (the standard library's zlib and
numpy, no Pillow), other 8-bit formats through Pillow when it is
importable.  8-bit images are taken as sRGB unless the color space says
otherwise (`raw_manual_gamma` raises them to `gamma`).  Saves apply the
film's output transform: .exr through io/exr.py's writer, .hdr through
io/rgbe.py, and 8-bit formats after the sRGB or manual-gamma transform,
clipped to [0, 1]: PNG (RGB, or RGBA with an alpha plane) through
`write_png` (zlib and numpy), JPEG, TGA and TIFF through Pillow.
"""
from __future__ import annotations

import os
import struct
import zlib

import numpy as np

_PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
# channels of the PNG colour types read_png decodes (8-bit, non-interlaced)
_PNG_CHANNELS = {0: 1, 2: 3, 4: 2, 6: 4}


def _srgb_to_linear(c):
    c = c.astype(np.float32)
    return np.where(c <= 0.04045, c / 12.92, ((c + 0.055) / 1.055) ** 2.4)


def _linear_to_srgb(c):
    c = np.clip(c, 0.0, 1.0)
    return np.where(c <= 0.0031308, c * 12.92,
                    1.055 * np.maximum(c, 1e-8) ** (1.0 / 2.4) - 0.055)


class PngFormatError(ValueError):
    """A PNG that read_png does not decode (palette, 16-bit, interlaced)."""


def _unfilter(raw: bytes, h: int, w: int, bpp: int) -> np.ndarray:
    """Undo the five PNG row filters: raw holds h rows of one filter byte
    and w·bpp bytes.  Returns (h, w·bpp) uint8."""
    stride = w * bpp
    rows = np.frombuffer(raw, np.uint8).reshape(h, stride + 1)
    out = np.zeros((h, stride), np.uint8)
    prior = np.zeros(stride, np.int32)
    for y in range(h):
        ftype = int(rows[y, 0])
        line = rows[y, 1:].astype(np.int32)
        if ftype == 0:  # none
            cur = line
        elif ftype == 1:  # sub: running sum per channel, mod 256
            cur = (np.cumsum(line.reshape(w, bpp), axis=0) & 255).reshape(-1)
        elif ftype == 2:  # up
            cur = (line + prior) & 255
        elif ftype in (3, 4):  # average, paeth: pixel by pixel
            cur = np.zeros(stride, np.int32)
            left = np.zeros(bpp, np.int32)
            upleft = np.zeros(bpp, np.int32)
            for x in range(w):
                sl = slice(x * bpp, (x + 1) * bpp)
                up = prior[sl]
                if ftype == 3:
                    pred = (left + up) >> 1
                else:
                    p = left + up - upleft
                    pa, pb, pc = (np.abs(p - left), np.abs(p - up),
                                  np.abs(p - upleft))
                    pred = np.where((pa <= pb) & (pa <= pc), left,
                                    np.where(pb <= pc, up, upleft))
                left = (line[sl] + pred) & 255
                cur[sl] = left
                upleft = up
        else:
            raise PngFormatError(f"PNG row {y}: unknown filter type {ftype}")
        out[y] = cur
        prior = cur
    return out


def read_png(path: str) -> np.ndarray:
    """Decode an 8-bit non-interlaced PNG of colour type 0 (grey), 2 (RGB),
    4 (grey + alpha) or 6 (RGBA) to uint8 (H, W, 3) or (H, W, 4), grey
    replicated into RGB (Pillow's convert("RGB") / convert("RGBA")).
    Raises PngFormatError for any other PNG."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:8] != _PNG_SIGNATURE:
        raise PngFormatError(f"{path}: not a PNG file")
    pos = 8
    header = None
    idat = []
    while pos + 8 <= len(data):
        length, ctype = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + length]
        pos += 12 + length
        if ctype == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif ctype == b"IDAT":
            idat.append(body)
        elif ctype == b"IEND":
            break
    if header is None:
        raise PngFormatError(f"{path}: no IHDR chunk")
    w, h, depth, ctype_, _, _, interlace = header
    if depth != 8 or ctype_ not in _PNG_CHANNELS or interlace != 0:
        raise PngFormatError(
            f"{path}: bit depth {depth}, colour type {ctype_}, interlace "
            f"{interlace} (read_png decodes 8-bit, non-interlaced colour "
            "types 0, 2, 4 and 6)")
    ch = _PNG_CHANNELS[ctype_]
    px = _unfilter(zlib.decompress(b"".join(idat)), h, w, ch).reshape(h, w,
                                                                       ch)
    if ch == 1:
        return np.repeat(px, 3, axis=-1)
    if ch == 2:
        return np.concatenate([np.repeat(px[..., :1], 3, axis=-1),
                               px[..., 1:]], axis=-1)
    return px


def write_png(path: str, u8: np.ndarray) -> None:
    """Encode uint8 (H, W, 3) or (H, W, 4) as an 8-bit non-interlaced PNG
    (colour type 2 or 6), every row filter 0."""
    h, w, ch = u8.shape
    rows = np.concatenate([np.zeros((h, 1), np.uint8),
                           np.ascontiguousarray(u8).reshape(h, w * ch)],
                          axis=1)

    def chunk(ctype: bytes, body: bytes) -> bytes:
        return (struct.pack(">I", len(body)) + ctype + body
                + struct.pack(">I", zlib.crc32(ctype + body) & 0xFFFFFFFF))

    ihdr = struct.pack(">IIBBBBB", w, h, 8, {3: 2, 4: 6}[ch], 0, 0, 0)
    with open(path, "wb") as f:
        f.write(_PNG_SIGNATURE + chunk(b"IHDR", ihdr)
                + chunk(b"IDAT", zlib.compress(rows.tobytes()))
                + chunk(b"IEND", b""))


def _read_8bit(path: str) -> np.ndarray:
    """uint8 (H, W, 3|4) of an 8-bit image: PNG through read_png, other
    formats (and PNGs it does not decode) through Pillow."""
    if path.lower().endswith(".png"):
        try:
            return read_png(path)
        except PngFormatError:
            pass
    try:
        from PIL import Image
    except ImportError as e:
        raise RuntimeError(
            f"{path}: this format needs Pillow, which is not installed "
            "(PNG of colour types 0/2/4/6, .hdr and .exr load without it)"
        ) from e
    with Image.open(path) as im:
        return np.asarray(im.convert("RGBA" if "A" in im.getbands()
                                     else "RGB"))


def load_image(path: str, color_space: str = "", gamma: float = 1.0):
    """Load any supported image into linear float32 (H, W, 3[4])."""
    ext = os.path.splitext(path)[1].lower()
    if ext == ".hdr":
        from .rgbe import read_hdr

        return read_hdr(path)
    if ext == ".exr":
        from .exr import read_exr

        return read_exr(path)
    arr = np.asarray(_read_8bit(path), np.float32) / 255.0
    cs = (color_space or "sRGB").lower()
    if cs == "srgb":
        arr[..., :3] = _srgb_to_linear(arr[..., :3])
    elif cs in ("raw_manual_gamma", "raw") and gamma != 1.0:
        arr[..., :3] = np.maximum(arr[..., :3], 0.0) ** gamma
    return arr


def save_image(path: str, img: np.ndarray, color_space: str = "sRGB",
               gamma: float = 1.0, alpha: np.ndarray | None = None) -> None:
    """img: (H, W, 3) LINEAR float32; the format follows the extension.
    EXR and HDR keep the linear values; 8-bit formats take the color
    space's transform and `alpha` (H, W) as a fourth channel."""
    img = np.asarray(img, np.float32)
    ext = os.path.splitext(path)[1].lower()
    if ext == ".hdr":
        from .rgbe import write_hdr

        write_hdr(path, img)
        return
    if ext == ".exr":
        from .exr import write_exr

        write_exr(path, img)
        return

    cs = (color_space or "sRGB").lower()
    if cs == "srgb":
        out = _linear_to_srgb(img)
    elif cs in ("raw_manual_gamma", "raw") and gamma != 1.0:
        out = np.clip(img, 0.0, 1.0) ** (1.0 / gamma)
    else:
        out = np.clip(img, 0.0, 1.0)
    u8 = (np.clip(out, 0.0, 1.0) * 255.0 + 0.5).astype(np.uint8)
    if alpha is not None:
        a8 = (np.clip(alpha, 0.0, 1.0) * 255.0 + 0.5).astype(np.uint8)
        u8 = np.concatenate([u8, a8[..., None]], axis=-1)
    if ext == ".png":
        write_png(path, u8)
        return

    from PIL import Image

    Image.fromarray(u8).save(path)


def save_multilayer_exr(path: str, layers: dict) -> None:
    """One EXR of every layer (name -> (H, W, C)): the combined image under
    "" and each render pass under its name (the reference's multilayer
    output), ZIPS."""
    from .exr import write_exr_multilayer

    write_exr_multilayer(path, layers)
