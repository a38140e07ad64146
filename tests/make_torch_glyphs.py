"""Write the glyph atlas of the port's captions,
video_dqn_tpu_torch/viz/glyphs_simplex.npz (committed; rerun only to
change it):

    python -m tests.make_torch_glyphs

It needs cv2 and runs nowhere else: the port composites the atlas with
numpy and never imports cv2. The JAX package captions its strips with
`cv2.putText(img, text, org, cv2.FONT_HERSHEY_SIMPLEX, 0.5, (0, 0, 0), 1)`.
OpenCV 5 draws that face from an outline font compiled into its binary,
Rubik (SIL Open Font License 1.1, as embedded in OpenCV 5.0.0),
antialiased; the atlas holds its glyphs at that one style, rendered by
the cv2 named in the file's `cv2_version`.

What the atlas relies on, and what this script checks on every pair of
printable characters before it writes:
  * a string is its glyphs, each drawn alone on white (its value `g`),
    composited at fixed integer advances, per channel, by
    dst = (dst * g + 127) // 255, with no kerning;
  * a glyph moved by whole pixels is the same glyph;
  * cv2.getTextSize's width is the sum of the advances plus 1 (0 for
    the empty string).
The file holds, for the characters 32..126 in order: `tiles`, each
glyph's values on white in one common box (uint8, 255 where there is no
ink; the three channels of black text are equal); `top` and `left`, the
box's offset from the text origin (the baseline's left end); `advance`.
"""

from pathlib import Path

import cv2
import numpy as np

from video_dqn_tpu_torch.viz import text

OUT = Path(__file__).resolve().parents[1] / "video_dqn_tpu_torch" / "viz" / "glyphs_simplex.npz"
FONT, SCALE, THICKNESS = cv2.FONT_HERSHEY_SIMPLEX, 0.5, 1
CODES = range(text.FIRST, text.LAST + 1)
# a canvas with room around the origin for any glyph of this size
CANVAS_H, CANVAS_W, ORG_X, ORG_Y = 48, 96, 24, 30


def cv2_text(img: np.ndarray, s: str, org) -> np.ndarray:
    cv2.putText(img, s, org, FONT, SCALE, (0, 0, 0), THICKNESS)
    return img


def cv2_width(s: str) -> int:
    return cv2.getTextSize(s, FONT, SCALE, THICKNESS)[0][0]


def alone(s: str) -> np.ndarray:
    return cv2_text(np.full((CANVAS_H, CANVAS_W, 3), 255, np.uint8), s, (ORG_X, ORG_Y))


def render_atlas() -> dict:
    """The atlas's arrays as cv2 renders them: each glyph alone on white,
    cut to the box that holds every glyph's ink; each advance found as
    the shift at which a following 'I' composites onto the glyph exactly
    as cv2 draws the pair."""
    renders = {c: alone(chr(c)) for c in CODES}
    for c, r in renders.items():
        if not (np.array_equal(r[..., 0], r[..., 1]) and np.array_equal(r[..., 0], r[..., 2])):
            raise AssertionError(f"glyph {chr(c)!r}: its channels differ")
    ink = np.stack([r[..., 0] < 255 for r in renders.values()]).any(axis=0)
    rows, cols = np.flatnonzero(ink.any(axis=1)), np.flatnonzero(ink.any(axis=0))
    if rows[0] == 0 or cols[0] == 0 or rows[-1] == CANVAS_H - 1 or cols[-1] == CANVAS_W - 1:
        raise AssertionError("a glyph reaches the canvas's edge: enlarge the canvas")
    box = np.s_[rows[0]:rows[-1] + 1, cols[0]:cols[-1] + 1]
    atlas = {
        "tiles": np.stack([renders[c][..., 0][box] for c in CODES]),
        "top": np.int32(rows[0] - ORG_Y),
        "left": np.int32(cols[0] - ORG_X),
        "advance": np.zeros(len(CODES), np.int32),
    }
    for k, c in enumerate(CODES):
        # the last glyph's advance moves nothing, so 'I' probes itself too
        want = alone(chr(c) + "I")
        found = []
        for shift in range(CANVAS_W - ORG_X - 16):
            atlas["advance"][k] = shift
            got = np.full_like(want, 255)
            text.draw(got, chr(c) + "I", (ORG_X, ORG_Y), atlas)
            if np.array_equal(got, want):
                found.append(shift)
        if len(found) != 1:
            raise AssertionError(f"glyph {chr(c)!r}: advances {found} reproduce cv2")
        atlas["advance"][k] = found[0]
    atlas["font"] = np.array("Rubik (SIL Open Font License 1.1), as embedded in OpenCV "
                             "5.0.0: FONT_HERSHEY_SIMPLEX, scale 0.5, thickness 1, black")
    atlas["cv2_version"] = np.array(cv2.__version__)
    return atlas


def check(atlas: dict) -> None:
    """Every pair of printable characters on white, and seeded strings on
    random backgrounds at origins that clip at each edge, as cv2 draws
    them; every width as getTextSize gives it."""
    for a in CODES:
        for b in CODES:
            s = chr(a) + chr(b)
            got = np.full((CANVAS_H, CANVAS_W, 3), 255, np.uint8)
            text.draw(got, s, (ORG_X, ORG_Y), atlas)
            if not np.array_equal(got, alone(s)):
                raise AssertionError(f"{s!r} composites other than cv2 draws it")
            if text.width(s, atlas) != cv2_width(s):
                raise AssertionError(f"{s!r}: width {text.width(s, atlas)}, "
                                     f"getTextSize {cv2_width(s)}")
    rng = np.random.default_rng(0)
    for _ in range(200):
        s = "".join(map(chr, rng.integers(text.FIRST, text.LAST + 1, rng.integers(1, 30))))
        bg = rng.integers(0, 256, (40, 120, 3), np.uint8)
        org = (int(rng.integers(-60, 130)), int(rng.integers(-5, 50)))
        got = bg.copy()
        text.draw(got, s, org, atlas)
        if not np.array_equal(got, cv2_text(bg.copy(), s, org)):
            raise AssertionError(f"{s!r} at {org} composites other than cv2 draws it")
        if text.width(s, atlas) != cv2_width(s):
            raise AssertionError(f"{s!r}: width differs from getTextSize's")


def main() -> None:
    atlas = render_atlas()
    check(atlas)
    np.savez_compressed(OUT, **atlas)
    print(f"wrote {OUT} ({OUT.stat().st_size} bytes, cv2 {cv2.__version__})")


if __name__ == "__main__":
    main()
