"""The port's H.264 decoder (data/h264.py over csrc/host/h264_decode.cc)
against libavcodec, frame by frame: the SHA-256 of every
decoded picture's NV12 planes in tests/data/torch_video/expected.npz
(recorded by tests/torch_video_util.py), for small.mp4 plain and
fragmented, the first kept frames of the 720p fixture, and short x264
clips of the coding tools small.mp4 does not use; the streams it refuses
raise with the reason, a damaged one raises ValueError. Jax-free."""

import numpy as np
import pytest

from video_dqn_tpu_torch.data.h264 import H264Decoder, decoded_frames
from video_dqn_tpu_torch.data.mp4 import Mp4Video
from tests import torch_port_util  # noqa: F401  (caps torch threads per worker)
from tests.torch_video_fixture import FEATURES, REFUSED, expected, feature_path, nv12_sha256, path

EXP = expected()


def frame_hashes(p) -> tuple:
    with Mp4Video(p) as video:
        got = [(t, nv12_sha256(*f.nv12())) for t, f in decoded_frames(video)]
        ticks = video.pts[video.display_order()]
    return [h for _, h in got], ticks


@pytest.mark.parametrize("name", ["small", "small_fragmented"])
def test_every_frame_equals_libavcodecs(name):
    hashes, ticks = frame_hashes(path(name))
    assert hashes == EXP["small_all_nv12_sha256"].tolist()
    np.testing.assert_array_equal(ticks, EXP[f"{name}_frame_pts"])


@pytest.mark.parametrize("name", list(FEATURES))
def test_coding_tools_equal_libavcodec(name):
    hashes, ticks = frame_hashes(feature_path(name))
    assert hashes == EXP[f"feature_{name}_nv12_sha256"].tolist()
    np.testing.assert_array_equal(ticks, EXP[f"feature_{name}_frame_pts"])


def test_720p_kept_frames_equal_libavcodecs():
    # the first 72 access units hold display frames 0 and 60 (kept at 0.5 fps)
    with Mp4Video(path("hd720")) as video, H264Decoder("hd720") as decoder:
        want = {int(EXP["hd720_frame_pts"][i]): h
                for i, h in zip(EXP["hd720_keep"][:2], EXP["hd720_nv12_sha256"][:2])}
        got = {}
        for au in video.access_units():
            if au.index == 72:
                break
            decoder.decode(au.data, au.index)
            if au.pts in want:
                assert decoder.size(au.index) == (1280, 720, False)
                got[au.pts] = nv12_sha256(*decoder.nv12(au.index, 1280, 720))
            decoder.release(au.index)
    assert got == want


@pytest.mark.parametrize("name", list(REFUSED))
def test_refused_streams_name_the_reason(name):
    reason = REFUSED[name][-1]
    with Mp4Video(feature_path(name)) as video:
        with pytest.raises(NotImplementedError, match=reason) as e:
            for _ in decoded_frames(video):
                pass
    assert str(feature_path(name)) in str(e.value)


def test_a_damaged_access_unit_raises():
    with Mp4Video(path("small")) as video, H264Decoder("small") as decoder:
        units = video.access_units()
        first = next(units)
        with pytest.raises(ValueError, match="small: H.264"):
            decoder.decode(first.data[:len(first.data) // 3], first.index)
        decoder.decode(first.data, first.index + 1000)  # a later good unit decodes
        assert decoder.size(first.index + 1000) == (160, 120, False)


def _nals(annexb: bytes) -> list:
    """The NAL units of an Annex B access unit, emulation prevention
    removed."""
    out = []
    for raw in annexb.split(b"\x00\x00\x01"):
        raw = raw.rstrip(b"\x00")
        if raw:
            out.append(raw.replace(b"\x00\x00\x03", b"\x00\x00"))
    return out


class _Bits:
    def __init__(self, data: bytes):
        self.bits, self.at = "".join(f"{b:08b}" for b in data), 0

    def u(self, n: int) -> int:
        v = int(self.bits[self.at:self.at + n] or "0", 2)
        self.at += n
        return v

    def ue(self) -> int:
        zeros = 0
        while self.bits[self.at] == "0":
            zeros, self.at = zeros + 1, self.at + 1
        return self.u(zeros + 1) - 1

    def se(self) -> int:
        k = self.ue()
        return (k + 1) // 2 if k % 2 else -(k // 2)


def _ue(v: int) -> str:
    b = f"{v + 1:b}"
    return "0" * (len(b) - 1) + b


def _escape(rbsp: bytes) -> bytes:
    out, zeros = bytearray(), 0
    for b in rbsp:
        if zeros >= 2 and b <= 3:
            out.append(3)
            zeros = 0
        out.append(b)
        zeros = zeros + 1 if b == 0 else 0
    return bytes(out)


def _slice_type(nal: bytes) -> int:
    b = _Bits(nal[1:])
    b.ue()
    return b.ue()


def _with_32_refs(nal: bytes, sps: bytes, pps: bytes) -> bytes:
    """A P slice NAL rewritten to num_ref_idx_active_override 32 with one
    reference list modification (the fields up to it parsed as 7.3.3 has
    them, for the frame-coded, POC type 0 or 2 stream of small.mp4)."""
    s = _Bits(sps[1:])
    profile = s.u(8)
    s.u(16), s.ue()
    if profile in (100, 110, 122, 244, 44, 83, 86, 118, 128, 138, 139, 134, 135):
        if s.ue() == 3:
            s.u(1)
        s.ue(), s.ue(), s.u(1)
        assert s.u(1) == 0  # no scaling matrix
    log2_frame_num = s.ue() + 4
    poc_type = s.ue()
    assert poc_type in (0, 2)
    log2_poc_lsb = s.ue() + 4 if poc_type == 0 else 0
    s.ue(), s.u(1), s.ue(), s.ue()
    assert s.u(1) == 1  # frame_mbs_only
    p = _Bits(pps[1:])
    p.ue(), p.ue(), p.u(1)
    bottom_field_poc = p.u(1)
    assert p.ue() == 0  # one slice group
    p.ue(), p.ue(), p.u(1), p.u(2), p.se(), p.se(), p.se(), p.u(1), p.u(1)
    assert p.u(1) == 0  # no redundant pictures
    b = _Bits(nal[1:])
    b.ue()
    assert b.ue() % 5 == 0  # a P slice
    b.ue(), b.u(log2_frame_num)
    if poc_type == 0:
        b.u(log2_poc_lsb)
        if bottom_field_poc:
            b.se()
    head = b.bits[:b.at]
    if b.u(1):
        b.ue()
    tail = b.bits[b.at:]
    bits = head + "1" + _ue(31) + "1" + _ue(0) + _ue(0) + _ue(3) + tail
    bits += "0" * (-len(bits) % 8)
    rbsp = bytes(int(bits[i:i + 8], 2) for i in range(0, len(bits), 8))
    return b"\x00\x00\x00\x01" + nal[:1] + _escape(rbsp)


def test_more_references_than_a_frame_may_name_raise():
    # a frame names at most 16 references a list (7.4.3); 32 with a
    # modification would shift the list one entry past its end
    with Mp4Video(path("small")) as video, H264Decoder("small") as decoder:
        units = video.access_units()
        first = next(units)
        decoder.decode(first.data, first.index)
        sps, pps = [n for n in _nals(first.data) if n[0] & 31 in (7, 8)]
        for au in units:
            nal = next((n for n in _nals(au.data) if n[0] & 31 == 1 and n[0] >> 5), None)
            if nal is not None and _slice_type(nal) % 5 == 0:
                break
        else:
            raise AssertionError("small.mp4 holds no reference P slice")
        with pytest.raises(ValueError, match="num_ref_idx_active > 16"):
            decoder.decode(_with_32_refs(nal, sps, pps), au.index)
