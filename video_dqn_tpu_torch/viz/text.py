"""Captions as the JAX package draws them (its
`cv2.putText(img, text, org, cv2.FONT_HERSHEY_SIMPLEX, 0.5, (0, 0, 0), 1)`
and `cv2.getTextSize`), pixel for pixel, without cv2.

The glyphs come from `glyphs_simplex.npz` beside this file: each printable
ASCII character (32..126) as cv2 renders it alone on white, in one common
box offset from the text origin, and its integer advance (written and
checked against cv2 by tests/make_torch_glyphs.py, which names the font
and the cv2 it was rendered with). A string is its glyphs composited at
those advances, per channel, by dst = (dst * g + 127) // 255, where g is
the glyph's value on white; cv2 draws exactly that, clips at the image's
edges as a crop would, and moves a glyph by whole pixels unchanged. Only
this one style exists: the JAX package draws no other.
"""

from __future__ import annotations

import functools
from pathlib import Path
from typing import Dict, Sequence

import numpy as np

ATLAS = Path(__file__).with_name("glyphs_simplex.npz")
FIRST, LAST = 32, 126  # the printable ASCII characters the atlas holds


@functools.lru_cache(maxsize=1)
def _atlas() -> Dict[str, np.ndarray]:
    with np.load(ATLAS) as f:
        return {k: f[k] for k in ("tiles", "top", "left", "advance")}


def _codes(text: str) -> np.ndarray:
    codes = np.frombuffer(text.encode("utf-32-le"), np.uint32).astype(np.int64)
    bad = (codes < FIRST) | (codes > LAST)
    if bad.any():
        raise ValueError(f"caption {text!r} holds {text[int(np.argmax(bad))]!r}: only "
                         f"printable ASCII (codes {FIRST}..{LAST}) can be drawn")
    return codes - FIRST


def draw(img: np.ndarray, text: str, org: Sequence[int], atlas: Dict[str, np.ndarray]) -> None:
    """Composite `text` onto the uint8 (H, W, C) `img` in place with the
    glyphs of `atlas`, its baseline starting at org = (x, y)."""
    tiles, advance = atlas["tiles"], atlas["advance"]
    th, tw = tiles.shape[1:]
    h, w = img.shape[:2]
    x = int(org[0]) + int(atlas["left"])
    y0 = int(org[1]) + int(atlas["top"])
    r0, r1 = max(y0, 0), min(y0 + th, h)
    for k in _codes(text):
        c0, c1 = max(x, 0), min(x + tw, w)
        if r0 < r1 and c0 < c1:
            g = tiles[k, r0 - y0:r1 - y0, c0 - x:c1 - x, None].astype(np.uint32)
            dst = img[r0:r1, c0:c1]
            dst[...] = (dst * g + 127) // 255
        x += int(advance[k])


def width(text: str, atlas: Dict[str, np.ndarray]) -> int:
    """The width cv2.getTextSize gives `text`: its advances plus 1."""
    return int(atlas["advance"][_codes(text)].sum()) + 1 if text else 0


def put_text(img: np.ndarray, text: str, org: Sequence[int]) -> np.ndarray:
    """cv2.putText(img, text, org, FONT_HERSHEY_SIMPLEX, 0.5, (0, 0, 0), 1)
    on a uint8 (H, W, C) image, in place; any origin, negative ones too.
    Characters outside 32..126 raise ValueError. Returns `img`."""
    draw(img, text, org, _atlas())
    return img


def text_width(text: str) -> int:
    """cv2.getTextSize(text, FONT_HERSHEY_SIMPLEX, 0.5, 1)[0][0]."""
    return width(text, _atlas())
