"""Logging / observability (port of libyafaray_tpu/utils/observability.py):
the leveled console log (the stdlib logger 'libyafaray_tpu_torch'), the
per-render TXT + HTML log export with a full scene/render parameter dump
and the parameter badge drawn into the output image, as the CLI uses them.
Numpy only (PIL imported at use for the badge).
"""
from __future__ import annotations

import html
import json
import logging
import time

import numpy as np

log = logging.getLogger("libyafaray_tpu_torch")


class RenderLog:
    """Collects per-render events + parameters; exports TXT/HTML."""

    def __init__(self, scene_name: str = ""):
        self.scene_name = scene_name
        self.events: list[tuple[float, str, str]] = []
        self.params: dict = {}
        self.t0 = time.time()

    def event(self, level: str, msg: str):
        self.events.append((time.time() - self.t0, level, msg))
        getattr(log, level if level != "verbose" else "debug", log.info)(msg)

    def set_params(self, section: str, params: dict):
        self.params[section] = dict(params)

    def export_txt(self, path: str):
        with open(path, "w", encoding="utf-8") as f:
            f.write(f"libyafaray_tpu_torch render log — {self.scene_name}\n")
            f.write("=" * 60 + "\n\nParameters\n----------\n")
            for section, p in self.params.items():
                f.write(f"[{section}]\n")
                for k, v in sorted(p.items()):
                    f.write(f"  {k} = {v}\n")
            f.write("\nEvents\n------\n")
            for t, level, msg in self.events:
                f.write(f"[{t:8.2f}s] {level.upper():8s} {msg}\n")

    def export_html(self, path: str):
        rows = "".join(
            f"<tr><td>{t:.2f}s</td><td>{html.escape(level)}</td>"
            f"<td>{html.escape(msg)}</td></tr>"
            for t, level, msg in self.events
        )
        params = "".join(
            f"<h3>{html.escape(s)}</h3><pre>"
            + html.escape(json.dumps(p, indent=2, default=str))
            + "</pre>"
            for s, p in self.params.items()
        )
        with open(path, "w", encoding="utf-8") as f:
            f.write(
                "<html><head><title>libyafaray_tpu_torch render log</title>"
                "</head><body>"
                f"<h1>{html.escape(self.scene_name)}</h1>{params}"
                f"<h2>Events</h2><table border=1>{rows}</table>"
                "</body></html>"
            )


def draw_badge(img: np.ndarray, lines: list[str]) -> np.ndarray:
    """Draw the parameter badge into the image bottom (reference
    imagefilm badge with embedded font; PIL's default bitmap font here).
    img: (H,W,3) float linear; returns a copy with the badge row."""
    try:
        from PIL import Image, ImageDraw
    except ImportError:
        return img
    h, w = img.shape[:2]
    band = max(14 * len(lines) + 6, 20)
    out = np.zeros((h + band, w, 3), img.dtype)
    out[:h] = img
    pil = Image.fromarray(
        (np.clip(out, 0, 1) * 255).astype(np.uint8)
    )
    d = ImageDraw.Draw(pil)
    for i, line in enumerate(lines):
        d.text((4, h + 3 + 14 * i), line, fill=(220, 220, 220))
    return np.asarray(pil, np.float32) / 255.0

