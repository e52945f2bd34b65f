"""Radiance RGBE (.hdr) codec (port of libyafaray_tpu/io/rgbe.py: flat
scanlines on write; flat and adaptive-RLE scanlines on read).  Pure
numpy."""
from __future__ import annotations

import numpy as np


def _rgbe_encode(rgb: np.ndarray) -> np.ndarray:
    m = rgb.max(axis=-1)
    e = np.zeros(m.shape, np.int32)
    nz = m > 1e-32
    e[nz] = np.ceil(np.log2(m[nz])).astype(np.int32) + 1
    scale = np.where(nz, 256.0 / np.exp2(e.astype(np.float64)), 0.0)
    mant = np.clip((rgb * scale[..., None]), 0, 255).astype(np.uint8)
    out = np.concatenate([mant, ((e + 128) * nz).astype(np.uint8)[..., None]],
                         axis=-1)
    return out


def _rgbe_decode(rgbe: np.ndarray) -> np.ndarray:
    e = rgbe[..., 3].astype(np.int32)
    scale = np.where(e > 0, np.exp2(e - 136.0), 0.0)  # 2^(e-128-8)
    return (rgbe[..., :3].astype(np.float32)
            * scale[..., None].astype(np.float32))


def write_hdr(path: str, img: np.ndarray):
    h, w = img.shape[:2]
    rgbe = _rgbe_encode(np.maximum(np.asarray(img, np.float64), 0.0))
    with open(path, "wb") as f:
        f.write(b"#?RADIANCE\nFORMAT=32-bit_rle_rgbe\n\n")
        f.write(f"-Y {h} +X {w}\n".encode())
        f.write(rgbe.astype(np.uint8).tobytes())  # flat (uncompressed)


def read_hdr(path: str) -> np.ndarray:
    with open(path, "rb") as f:
        data = f.read()
    # header ends at empty line, then resolution line
    pos = 0
    lines = []
    while True:
        nl = data.index(b"\n", pos)
        line = data[pos:nl]
        pos = nl + 1
        if line.startswith(b"-Y") or line.startswith(b"+Y"):
            lines.append(line)
            break
        lines.append(line)
    res = lines[-1].split()
    h, w = int(res[1]), int(res[3])
    body = data[pos:]
    out = np.zeros((h, w, 4), np.uint8)
    # handle both flat and adaptive-RLE scanlines
    bpos = 0
    for y in range(h):
        if bpos + 4 <= len(body) and body[bpos] == 2 and body[bpos + 1] == 2 \
                and (body[bpos + 2] << 8 | body[bpos + 3]) == w:
            bpos += 4
            for c in range(4):
                x = 0
                while x < w:
                    cnt = body[bpos]
                    bpos += 1
                    if cnt > 128:  # run
                        out[y, x:x + cnt - 128, c] = body[bpos]
                        bpos += 1
                        x += cnt - 128
                    else:  # literal
                        out[y, x:x + cnt, c] = np.frombuffer(
                            body, np.uint8, cnt, bpos
                        )
                        bpos += cnt
                        x += cnt
        else:
            row = np.frombuffer(body, np.uint8, w * 4, bpos).reshape(w, 4)
            out[y] = row
            bpos += w * 4
    return _rgbe_decode(out)
