"""The port's captions (video_dqn_tpu_torch/viz/text.py) against cv2, the
JAX package's text renderer: put_text pixel-equal to cv2.putText at the
JAX package's style (FONT_HERSHEY_SIMPLEX, 0.5, thickness 1, black) for
every printable glyph and for seeded strings at origins that clip at
each edge of random backgrounds; text_width equal to getTextSize's; the
committed atlas equal to a fresh render of it by its generator."""

import numpy as np
import pytest

from video_dqn_tpu_torch.viz import text

cv2 = pytest.importorskip("cv2")
make_glyphs = pytest.importorskip("tests.make_torch_glyphs")

PRINTABLE = "".join(map(chr, range(text.FIRST, text.LAST + 1)))


def cv2_text(img, s, org):
    cv2.putText(img, s, org, cv2.FONT_HERSHEY_SIMPLEX, 0.5, (0, 0, 0), 1)
    return img


def seeded_strings(n=200, seed=0):
    """(string, origin, background) cases: random printable strings of 1
    to 40 characters on random backgrounds, the origins spread so that
    text runs off the left, right, top and bottom edges."""
    rng = np.random.default_rng(seed)
    cases = []
    for k in range(n):
        s = "".join(map(chr, rng.integers(text.FIRST, text.LAST + 1, rng.integers(1, 41))))
        h, w = int(rng.integers(8, 60)), int(rng.integers(8, 200))
        edge = k % 5  # left, right, top, bottom, inside
        x = [int(rng.integers(-120, 0)), int(rng.integers(w - 20, w + 5)),
             int(rng.integers(0, w))][min(edge, 2)]
        y = [int(rng.integers(0, h + 14)), int(rng.integers(0, h + 14)),
             int(rng.integers(-10, 6)), int(rng.integers(h - 2, h + 12)),
             int(rng.integers(12, max(h, 13)))][edge]
        cases.append((s, (x, y), rng.integers(0, 256, (h, w, 3), np.uint8)))
    return cases


def test_every_glyph_equals_cv2s():
    for ch in PRINTABLE:
        want = cv2_text(np.full((30, 24, 3), 255, np.uint8), ch, (4, 20))
        got = text.put_text(np.full((30, 24, 3), 255, np.uint8), ch, (4, 20))
        np.testing.assert_array_equal(got, want, err_msg=repr(ch))
    want = cv2_text(np.full((30, 900, 3), 255, np.uint8), PRINTABLE, (3, 20))
    np.testing.assert_array_equal(
        text.put_text(np.full((30, 900, 3), 255, np.uint8), PRINTABLE, (3, 20)), want)


def test_seeded_strings_equal_cv2s_at_every_edge():
    clipped = set()
    for s, org, bg in seeded_strings():
        want = cv2_text(bg.copy(), s, org)
        got = bg.copy()
        assert text.put_text(got, s, org) is got
        np.testing.assert_array_equal(got, want, err_msg=f"{s!r} at {org}")
        h, w = bg.shape[:2]
        w_text = text.text_width(s)
        clipped.update(side for side, out in (("left", org[0] < 0),
                                              ("right", org[0] + w_text > w),
                                              ("top", org[1] - 11 < 0),
                                              ("bottom", org[1] + 3 > h)) if out)
    assert clipped == {"left", "right", "top", "bottom"}


def test_text_width_equals_get_text_size():
    strings = ["", "0", " ", "step 7", "Object Class: Dining Table", "Predicted Values",
               PRINTABLE] + [s for s, _, _ in seeded_strings()]
    for s in strings:
        assert text.text_width(s) == \
            cv2.getTextSize(s, cv2.FONT_HERSHEY_SIMPLEX, 0.5, 1)[0][0], repr(s)
    assert [text.text_width(s) for s in ("0", " ", "step 7", "Object Class: Dining Table")] \
        == [10, 4, 41, 166]


def test_atlas_on_disk_equals_a_fresh_render():
    fresh = make_glyphs.render_atlas()
    with np.load(text.ATLAS) as disk:
        assert sorted(disk.files) == sorted(fresh)
        for key, value in fresh.items():
            np.testing.assert_array_equal(disk[key], value, err_msg=key)
            assert disk[key].dtype == np.asarray(value).dtype, key


@pytest.mark.parametrize("bad", ["café", "line\nbreak", "tab\there", "→", "\x7f"])
def test_characters_outside_printable_ascii_raise(bad):
    img = np.full((20, 60, 3), 255, np.uint8)
    with pytest.raises(ValueError, match="printable ASCII"):
        text.put_text(img, bad, (2, 15))
    with pytest.raises(ValueError, match="printable ASCII"):
        text.text_width(bad)
    assert (img == 255).all()
