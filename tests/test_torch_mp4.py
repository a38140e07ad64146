"""The port's MP4 demuxer (data/mp4.py over csrc/host/mp4_demux.cc) against
libavformat, as the JAX package's decode stage reads the
same files (tests/data/torch_video/expected.npz, recorded by
tests/torch_video_util.py): the samples' pts, key flags and count in
decode order, the display-order pts of the shown frames, for the plain,
fragmented and 720p fixtures and for small.mp4 rewritten with other edit
lists, signed composition offsets and a version-1 trun; the Annex B form;
and the files it refuses."""

import struct

import numpy as np
import pytest

from video_dqn_tpu_torch.data.mp4 import Mp4Video, demux
from tests import torch_port_util  # noqa: F401  (caps torch threads per worker)
from tests import torch_video_util
from tests.torch_video_fixture import (AV_PKT_FLAG_DISCARD, AV_PKT_FLAG_KEY, VIDEOS, expected,
                                       path)

EXP = expected()


def shown_packets(video: Mp4Video) -> list:
    """(pts, key) of the shown samples in decode order."""
    return [(int(p), bool(k)) for p, k, s in zip(video.pts, video.key, video.shown) if s]


def libav_packets(pts, flags) -> list:
    return [(int(p), bool(f & AV_PKT_FLAG_KEY)) for p, f in zip(pts, flags)
            if not f & AV_PKT_FLAG_DISCARD]


@pytest.mark.parametrize("video", VIDEOS)
def test_samples_match_libavformat(video):
    with Mp4Video(path(video)) as m:
        assert m.codec == "avc1" and m.timescale == EXP[f"{video}_timescale"]
        assert len(m) == len(EXP[f"{video}_packet_pts"])
        assert m.shown.all()
        assert shown_packets(m) == libav_packets(EXP[f"{video}_packet_pts"],
                                                 EXP[f"{video}_packet_flags"])
        display = m.pts[m.display_order()]
        np.testing.assert_array_equal(display, EXP[f"{video}_frame_pts"])
        assert display[0] == 0  # the edit list applied
        assert (m.width, m.height) == ((160, 120) if video.startswith("small") else (1280, 720))


@pytest.mark.parametrize("name", list(torch_video_util.VARIANTS))
def test_edit_lists_and_offsets_as_libavformat_applies_them(tmp_path, name):
    p = tmp_path / f"{name}.mp4"
    p.write_bytes(torch_video_util.variant(name))
    with Mp4Video(p) as m:
        assert shown_packets(m) == libav_packets(EXP[f"variant_{name}_packet_pts"],
                                                 EXP[f"variant_{name}_packet_flags"])
        np.testing.assert_array_equal(m.pts[m.display_order()],
                                      EXP[f"variant_{name}_frame_pts"])


def test_plain_and_fragmented_give_the_same_access_units():
    plain, fragmented = demux(path("small")), demux(path("small_fragmented"))
    assert len(plain) == len(fragmented) == 360
    for a, b in zip(plain, fragmented):
        assert (a.data, a.pts, a.key, a.shown) == (b.data, b.pts, b.key, b.shown)


def nal_types(annex_b: bytes) -> list:
    parts = annex_b.split(b"\x00\x00\x00\x01")
    assert parts[0] == b""
    return [p[0] & 0x1F for p in parts[1:]]


def test_access_units_are_annex_b_with_parameter_sets_before_each_idr():
    units = demux(path("small"))
    sizes = EXP["small_packet_size"]
    grown = set()
    for au in units:
        types = nal_types(au.data)
        if 5 in types:  # an IDR: the SPS and PPS come before its first slice
            assert au.key and types.index(7) < types.index(8) < types.index(5)
        else:
            assert 7 not in types and 8 not in types
        # each 4-byte NAL length became a start code: only the parameter
        # sets add bytes
        grown.add(len(au.data) - int(sizes[au.index]))
    assert sum(u.key for u in units) == sum(5 in nal_types(u.data) for u in units) > 1
    assert len(grown) == 2 and 0 in grown


@pytest.mark.parametrize("code", [b"hvc1", b"hev1", b"av01", b"mp4v"])
def test_other_sample_entries_raise_naming_their_code(tmp_path, code):
    p = tmp_path / "other.mp4"
    p.write_bytes(torch_video_util.with_sample_entry(path("small").read_bytes(), code))
    with pytest.raises(ValueError, match=f"'{code.decode()}'") as e:
        Mp4Video(p)
    assert str(p) in str(e.value)


@pytest.mark.parametrize("cut", [0.02, 0.5, 0.98])
@pytest.mark.parametrize("video", ["small", "small_fragmented"])
def test_truncated_files_raise_with_their_path(tmp_path, video, cut):
    data = path(video).read_bytes()
    p = tmp_path / "cut.mp4"
    p.write_bytes(data[:int(len(data) * cut)])
    with pytest.raises(ValueError) as e:
        with Mp4Video(p) as m:
            demux(p)
            m.close()
    assert str(p) in str(e.value)


def test_a_nal_length_past_its_sample_raises(tmp_path):
    data = bytearray(path("small").read_bytes())
    offset = torch_video_util.sample_table(bytes(data))["offset"][5]
    data[offset:offset + 4] = struct.pack(">I", 1 << 30)
    p = tmp_path / "bad.mp4"
    p.write_bytes(bytes(data))
    with Mp4Video(p) as m:
        with pytest.raises(ValueError, match="sample 5 has a NAL of") as e:
            list(m.access_units())
    assert str(p) in str(e.value)


def test_a_missing_file_raises_oserror(tmp_path):
    with pytest.raises(OSError, match="cannot be opened"):
        Mp4Video(tmp_path / "none.mp4")
