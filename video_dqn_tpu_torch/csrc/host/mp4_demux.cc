// MP4 (ISO BMFF) demuxer for the H.264 video track, written from ISO/IEC
// 14496-12 and -15 with no codec library: the container half of frame
// extraction, whose decoder is csrc/host/h264_decode.cc.
//
// Counterpart of libavformat's mov demuxer as the JAX package's decode stage
// runs it (native/decode/decode.cc: avformat_open_input, av_read_frame),
// for what that stage reads of a video track:
//   * ftyp, moov/mvhd (the movie timescale), the first trak whose hdlr is
//     'vide': tkhd (track id), mdia/mdhd (timescale), stbl/stsd (one avc1
//     or avc3 entry and its avcC: the NAL length size, the SPS and PPS),
//     stts, ctts (versions 0 and 1, read signed as libavformat reads
//     both), stsc, stsz, stco/co64 and stss (no stss: every sample syncs);
//   * fragmented files: moov/mvex/trex, then every top-level moof's traf of
//     that track: tfhd (base offset, defaults, default-base-is-moof), tfdt
//     and trun (versions 0 and 1), as YouTube's DASH streams are written;
//   * edts/elst as libavformat applies it (mov.c, advanced edit lists on,
//     its default): leading empty edits E and one media edit (media time
//     M, duration D, both rescaled to the media timescale, rounded to
//     nearest). In the sample tables a sample whose composition time
//     (dts + ctts) lies outside [M, M + D) is sent to the decoder but not
//     shown, and a shown sample's pts is its composition time less the
//     least shown one, plus E (no edit list: dts + ctts); in fragments every
//     sample is shown with pts dts + ctts - (M - E) + S, where S is
//     libavformat's dts_shift: the largest negative composition offset of
//     the fragments read up to the sample's own.
// Each sample is handed back as Annex B: every NAL unit behind a 4-byte
// start code, and avcC's SPS and PPS before the first IDR slice of a
// sample, as libavcodec's decoder has them from the extradata.
// Other sample entries (hvc1, hev1, av01, mp4v, encv, ...) raise naming
// their four-letter code; more than one media edit, a media rate other than
// 1, a compact stz2 table and samples in both the moov and fragments raise
// as not supported; a truncated or malformed file raises with what is
// wrong. The Python side (data/mp4.py) adds the path.
//
// C ABI (ctypes; video_dqn_tpu_torch/data/mp4.py):
//   void* vdqn_mp4_open(const char* path, int32_t* code, char* err, int err_len);
//       null on failure: code 1 cannot be read, 2 malformed or truncated,
//       3 not supported (the reason in err)
//   void vdqn_mp4_info(void* h, int64_t* info);
//       info[0..5]: samples, timescale, width, height, NAL length size,
//       the sample entry's four-letter code as a big-endian integer
//   void vdqn_mp4_samples(void* h, int64_t* pts, int64_t* dts, uint8_t* key,
//                         uint8_t* shown, int64_t* bound);
//       per sample in decode order: pts and dts in timescale ticks (pts
//       after the edit list, meaningful where shown), the sync flag, the
//       shown flag, and a bound on its Annex B size
//   int64_t vdqn_mp4_read(void* h, int64_t first, int64_t count, uint8_t* out,
//                         int64_t capacity, int64_t* ends, int32_t* code,
//                         char* err, int err_len);
//       the Annex B bytes of samples [first, first + count) into out, the end
//       of each in ends; returns the bytes written, or -1 (code, err)
//   void vdqn_mp4_close(void* h);

#include <algorithm>
#include <cinttypes>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <map>
#include <memory>
#include <string>
#include <vector>

namespace {

enum Code { kOk = 0, kIoError = 1, kMalformed = 2, kUnsupported = 3 };

struct Failure {
  int code;
  std::string what;
};

[[noreturn]] void fail(int code, const std::string& what) { throw Failure{code, what}; }

std::string fourcc(uint32_t t) {
  std::string s;
  for (int shift = 24; shift >= 0; shift -= 8) {
    const char c = (char)((t >> shift) & 0xFF);
    s += (c >= 32 && c < 127) ? c : '?';
  }
  return s;
}

constexpr uint32_t tag(const char (&s)[5]) {
  return (uint32_t)(uint8_t)s[0] << 24 | (uint32_t)(uint8_t)s[1] << 16 |
         (uint32_t)(uint8_t)s[2] << 8 | (uint32_t)(uint8_t)s[3];
}

// A bounds-checked big-endian view of bytes in memory.
struct View {
  const uint8_t* p = nullptr;
  int64_t n = 0;
  const char* what = "box";

  void need(int64_t at, int64_t len) const {
    if (at < 0 || len < 0 || at + len > n)
      fail(kMalformed, std::string(what) + " is shorter than its fields");
  }
  uint32_t u8(int64_t at) const { need(at, 1); return p[at]; }
  uint32_t u16(int64_t at) const { need(at, 2); return (uint32_t)p[at] << 8 | p[at + 1]; }
  uint32_t u32(int64_t at) const {
    need(at, 4);
    return (uint32_t)p[at] << 24 | (uint32_t)p[at + 1] << 16 | (uint32_t)p[at + 2] << 8 | p[at + 3];
  }
  uint64_t u64(int64_t at) const { return (uint64_t)u32(at) << 32 | u32(at + 4); }
  View sub(int64_t at, int64_t len, const char* name) const {
    need(at, len);
    return View{p + at, len, name};
  }
};

struct Box {
  uint32_t type;
  int64_t start, body, end;  // offsets in the enclosing space
};

// The box at `at` in a space of `limit` bytes, from its header bytes.
Box parse_header(const uint8_t* h, int64_t avail, int64_t at, int64_t limit) {
  if (avail < 8) fail(kMalformed, "truncated box header at offset " + std::to_string(at));
  const uint64_t size32 = (uint32_t)h[0] << 24 | (uint32_t)h[1] << 16 | (uint32_t)h[2] << 8 | h[3];
  const uint32_t type = (uint32_t)h[4] << 24 | (uint32_t)h[5] << 16 | (uint32_t)h[6] << 8 | h[7];
  int64_t size = (int64_t)size32, head = 8;
  if (size32 == 1) {
    if (avail < 16) fail(kMalformed, "truncated box header at offset " + std::to_string(at));
    uint64_t big = 0;
    for (int i = 8; i < 16; i++) big = big << 8 | h[i];
    if (big > (uint64_t)INT64_MAX) fail(kMalformed, "box '" + fourcc(type) + "' too large");
    size = (int64_t)big;
    head = 16;
  } else if (size32 == 0) {
    size = limit - at;  // to the end of the enclosing space
  }
  if (size < head)
    fail(kMalformed, "box '" + fourcc(type) + "' at offset " + std::to_string(at) +
                         " has size " + std::to_string(size));
  if (at + size > limit)
    fail(kMalformed, "box '" + fourcc(type) + "' at offset " + std::to_string(at) +
                         " runs past the end of what holds it (truncated?)");
  return Box{type, at, at + head, at + size};
}

std::vector<Box> children(const View& v, int64_t from = 0) {
  std::vector<Box> out;
  for (int64_t at = from; at < v.n;) {
    const int64_t avail = std::min<int64_t>(16, v.n - at);
    Box b = parse_header(v.p + at, avail, at, v.n);
    out.push_back(b);
    at = b.end;
  }
  return out;
}

const Box* first(const std::vector<Box>& boxes, uint32_t type) {
  for (const Box& b : boxes)
    if (b.type == type) return &b;
  return nullptr;
}

View body(const View& parent, const Box& b, const char* name) {
  return parent.sub(b.body, b.end - b.body, name);
}

struct Edit {
  int64_t duration;    // movie timescale
  int64_t media_time;  // media timescale, -1: empty
};

struct Trex {
  uint32_t duration = 0, size = 0, flags = 0;
};

struct Sample {
  int64_t offset, size, dts, cto, pts;
  int64_t shift;  // fragments: libavformat's dts_shift when it reads the sample
  bool key, shown;
};

// av_rescale(a, b, c): a * b / c rounded to nearest, halves away from zero
int64_t rescale(int64_t a, int64_t b, int64_t c) {
  const __int128 num = (__int128)a * b;
  const __int128 half = c / 2;
  return (int64_t)(num >= 0 ? (num + half) / c : -((-num + half) / c));
}

class Demuxer {
 public:
  explicit Demuxer(const char* path) : file_(std::fopen(path, "rb"), &std::fclose) {
    if (!file_) fail(kIoError, "cannot be opened for reading");
    if (std::fseek(file_.get(), 0, SEEK_END) != 0) fail(kIoError, "cannot be read");
    size_ = std::ftell(file_.get());
    parse();
  }

  int64_t timescale = 0, width = 0, height = 0, nal_size = 0;
  uint32_t entry = 0;
  std::vector<Sample> samples;

  // Annex B bytes of samples [first, first + count) into out.
  int64_t read(int64_t first, int64_t count, uint8_t* out, int64_t capacity, int64_t* ends) {
    int64_t w = 0;
    std::vector<uint8_t> buf;
    for (int64_t i = first; i < first + count; i++) {
      const Sample& s = samples[(size_t)i];
      buf.resize((size_t)s.size);
      read_at(s.offset, s.size, buf.data(), "sample " + std::to_string(i));
      const View v{buf.data(), s.size, "sample"};
      bool params_done = false;
      for (int64_t at = 0; at < s.size;) {
        if (at + nal_size > s.size)
          fail(kMalformed, "sample " + std::to_string(i) + " ends inside a NAL length");
        int64_t len = 0;
        for (int64_t k = 0; k < nal_size; k++) len = len << 8 | v.p[at + k];
        at += nal_size;
        if (len == 0) continue;
        if (at + len > s.size)
          fail(kMalformed, "sample " + std::to_string(i) + " has a NAL of " + std::to_string(len) +
                               " bytes past its end");
        if (!params_done && (v.p[at] & 0x1F) == 5) {  // the first IDR slice
          for (const auto& ps : params_) put(ps.data(), (int64_t)ps.size(), out, capacity, w);
          params_done = true;
        }
        put(v.p + at, len, out, capacity, w);
        at += len;
      }
      ends[i - first] = w;
    }
    return w;
  }

  // A bound on sample i's Annex B size: each NAL takes at least
  // nal_size + 1 bytes and grows by 4 - nal_size, and the parameter sets
  // may go before it.
  int64_t bound(const Sample& s) const {
    return s.size + (4 - nal_size) * (s.size / (nal_size + 1) + 1) + params_bytes_;
  }

 private:
  std::unique_ptr<std::FILE, int (*)(std::FILE*)> file_;
  int64_t size_ = 0;
  int64_t movie_timescale_ = 0;
  uint32_t track_id_ = 0;
  std::vector<Edit> edits_;
  std::map<uint32_t, Trex> trex_;
  std::vector<std::vector<uint8_t>> params_;  // SPS then PPS
  int64_t params_bytes_ = 0;
  bool have_track_ = false;

  static void put(const uint8_t* p, int64_t n, uint8_t* out, int64_t cap, int64_t& w) {
    if (w + 4 + n > cap) fail(kMalformed, "Annex B output larger than its bound");
    out[w] = 0; out[w + 1] = 0; out[w + 2] = 0; out[w + 3] = 1;
    std::memcpy(out + w + 4, p, (size_t)n);
    w += 4 + n;
  }

  void read_at(int64_t at, int64_t n, uint8_t* dst, const std::string& what) {
    if (at < 0 || n < 0 || at + n > size_)
      fail(kMalformed, what + " lies past the end of the file (truncated?)");
    if (std::fseek(file_.get(), at, SEEK_SET) != 0 ||
        (int64_t)std::fread(dst, 1, (size_t)n, file_.get()) != n)
      fail(kIoError, "read error at offset " + std::to_string(at));
  }

  std::vector<uint8_t> load(const Box& b) {
    std::vector<uint8_t> data((size_t)(b.end - b.body));
    read_at(b.body, b.end - b.body, data.data(), "box '" + fourcc(b.type) + "'");
    return data;
  }

  void parse() {
    bool have_moov = false;
    std::vector<std::vector<uint8_t>> moofs;
    std::vector<int64_t> moof_at;
    for (int64_t at = 0; at < size_;) {
      uint8_t h[16];
      const int64_t avail = std::min<int64_t>(16, size_ - at);
      read_at(at, avail, h, "box header");
      Box b = parse_header(h, avail, at, size_);
      if (b.type == tag("moov")) {
        if (have_moov) fail(kMalformed, "two moov boxes");
        std::vector<uint8_t> moov = load(b);
        parse_moov(View{moov.data(), (int64_t)moov.size(), "moov"});
        have_moov = true;
      } else if (b.type == tag("moof")) {
        moofs.push_back(load(b));
        moof_at.push_back(b.start);
      }
      at = b.end;
    }
    if (!have_moov) fail(kMalformed, "has no moov box");
    if (!have_track_) fail(kUnsupported, "has no video track");
    if (!moofs.empty() && !samples.empty())
      fail(kUnsupported, "holds samples both in its moov and in fragments");
    if (moofs.empty()) {
      apply_edit_list();
    } else {
      int64_t next_dts = 0, shift = 0;
      for (size_t i = 0; i < moofs.size(); i++) {
        const size_t before = samples.size();
        parse_moof(View{moofs[i].data(), (int64_t)moofs[i].size(), "moof"}, moof_at[i], next_dts);
        // libavformat reads a fragment when it reaches it, and its
        // dts_shift is the largest negative composition offset read so far
        for (size_t k = before; k < samples.size(); k++) shift = std::max(shift, -samples[k].cto);
        for (size_t k = before; k < samples.size(); k++) samples[k].shift = shift;
      }
      offset_fragments();
    }
    if (samples.empty()) fail(kMalformed, "has no video samples");
    for (size_t i = 0; i < samples.size(); i++)
      if (samples[i].offset < 0 || samples[i].offset + samples[i].size > size_)
        fail(kMalformed, "sample " + std::to_string(i) + " lies past the end of the file (truncated?)");
  }

  void parse_moov(const View& moov) {
    const auto boxes = children(moov);
    if (const Box* mvhd = first(boxes, tag("mvhd"))) {
      const View v = body(moov, *mvhd, "mvhd");
      movie_timescale_ = v.u32(v.u8(0) == 1 ? 20 : 12);
    }
    for (const Box& b : boxes) {
      if (b.type == tag("trak") && !have_track_) parse_trak(body(moov, b, "trak"));
      if (b.type == tag("mvex")) {
        const View mvex = body(moov, b, "mvex");
        for (const Box& t : children(mvex))
          if (t.type == tag("trex")) {
            const View v = body(mvex, t, "trex");
            trex_[v.u32(4)] = Trex{v.u32(12), v.u32(16), v.u32(20)};
          }
      }
    }
  }

  void parse_trak(const View& trak) {
    const auto boxes = children(trak);
    const Box* mdia_box = first(boxes, tag("mdia"));
    if (!mdia_box) fail(kMalformed, "has a trak without mdia");
    const View mdia = body(trak, *mdia_box, "mdia");
    const auto mboxes = children(mdia);
    const Box* hdlr = first(mboxes, tag("hdlr"));
    if (!hdlr || body(mdia, *hdlr, "hdlr").u32(8) != tag("vide")) return;  // not video
    have_track_ = true;
    if (const Box* tkhd = first(boxes, tag("tkhd"))) {
      const View v = body(trak, *tkhd, "tkhd");
      track_id_ = v.u32(v.u8(0) == 1 ? 20 : 12);
    }
    if (const Box* edts = first(boxes, tag("edts"))) {
      const View e = body(trak, *edts, "edts");
      if (const Box* elst = first(children(e), tag("elst"))) {
        const View v = body(e, *elst, "elst");
        const bool v1 = v.u8(0) == 1;
        const uint32_t n = v.u32(4);
        const int64_t step = v1 ? 20 : 12;
        v.need(8, step * (int64_t)n);
        for (uint32_t i = 0; i < n; i++) {
          const int64_t at = 8 + step * i;
          const int64_t dur = v1 ? (int64_t)v.u64(at) : (int64_t)v.u32(at);
          const int64_t time = v1 ? (int64_t)v.u64(at + 8) : (int64_t)(int32_t)v.u32(at + 4);
          if (v.u16(at + (v1 ? 16 : 8)) != 1 || v.u16(at + (v1 ? 18 : 10)) != 0)
            fail(kUnsupported, "has an edit with a media rate other than 1");
          edits_.push_back(Edit{dur, time});
        }
      }
    }
    const Box* mdhd = first(mboxes, tag("mdhd"));
    if (!mdhd) fail(kMalformed, "has a video track without mdhd");
    {
      const View v = body(mdia, *mdhd, "mdhd");
      timescale = v.u32(v.u8(0) == 1 ? 20 : 12);
      if (timescale <= 0) fail(kMalformed, "has a timescale of 0");
    }
    const Box* minf_box = first(mboxes, tag("minf"));
    if (!minf_box) fail(kMalformed, "has a video track without minf");
    const View minf = body(mdia, *minf_box, "minf");
    const Box* stbl_box = first(children(minf), tag("stbl"));
    if (!stbl_box) fail(kMalformed, "has a video track without stbl");
    parse_stbl(body(minf, *stbl_box, "stbl"));
  }

  void parse_stsd(const View& stsd) {
    const uint32_t n = stsd.u32(4);
    if (n == 0) fail(kMalformed, "has an empty stsd");
    const auto entries = children(stsd, 8);
    if (entries.empty()) fail(kMalformed, "has an empty stsd");
    const Box& e = entries[0];
    entry = e.type;
    if (e.type != tag("avc1") && e.type != tag("avc3"))
      fail(kUnsupported, "has a '" + fourcc(e.type) + "' video sample entry; only H.264 "
                         "('avc1', 'avc3') is demuxed");
    if (n > 1) fail(kUnsupported, "has " + std::to_string(n) + " sample entries");
    const View v = stsd.sub(e.start, e.end - e.start, "avc1");
    width = v.u16(32);
    height = v.u16(34);
    const Box* avcc_box = first(children(v, 86), tag("avcC"));
    if (!avcc_box) fail(kMalformed, "has an avc1 entry without avcC");
    const View c = body(v, *avcc_box, "avcC");
    nal_size = (c.u8(4) & 3) + 1;
    if (nal_size == 3) fail(kMalformed, "has a NAL length size of 3");
    int64_t at = 5;
    for (int set = 0; set < 2; set++) {  // SPS, then PPS
      const uint32_t count = set == 0 ? (c.u8(at) & 0x1F) : c.u8(at);
      at += 1;
      for (uint32_t i = 0; i < count; i++) {
        const int64_t len = c.u16(at);
        c.need(at + 2, len);
        params_.emplace_back(c.p + at + 2, c.p + at + 2 + len);
        params_bytes_ += 4 + len;
        at += 2 + len;
      }
    }
  }

  void parse_stbl(const View& stbl) {
    const auto boxes = children(stbl);
    const Box* stsd = first(boxes, tag("stsd"));
    if (!stsd) fail(kMalformed, "has no stsd");
    parse_stsd(body(stbl, *stsd, "stsd"));
    if (first(boxes, tag("stz2"))) fail(kUnsupported, "has a compact sample size table (stz2)");
    const Box* stsz_box = first(boxes, tag("stsz"));
    const Box* stts_box = first(boxes, tag("stts"));
    const Box* stsc_box = first(boxes, tag("stsc"));
    const Box* stco_box = first(boxes, tag("stco"));
    const Box* co64_box = first(boxes, tag("co64"));
    if (!stsz_box || !stts_box || !stsc_box || !(stco_box || co64_box))
      fail(kMalformed, "lacks one of stsz, stts, stsc and stco/co64");
    const View stsz = body(stbl, *stsz_box, "stsz");
    const uint32_t fixed = stsz.u32(4);
    const int64_t n = stsz.u32(8);
    if (n == 0) return;  // fragmented: the samples are in moofs
    if (fixed == 0) stsz.need(12, 4 * n);
    samples.assign((size_t)n, Sample{});
    for (int64_t i = 0; i < n; i++) {
      samples[(size_t)i].size = fixed ? fixed : stsz.u32(12 + 4 * i);
      samples[(size_t)i].key = true;
    }

    const View stts = body(stbl, *stts_box, "stts");
    int64_t i = 0, dts = 0;
    const uint32_t n_stts = stts.u32(4);
    stts.need(8, 8 * (int64_t)n_stts);
    for (uint32_t e = 0; e < n_stts; e++)
      for (uint32_t k = 0, count = stts.u32(8 + 8 * e); k < count && i < n; k++, i++) {
        samples[(size_t)i].dts = dts;
        dts += stts.u32(12 + 8 * e);
      }
    if (i != n) fail(kMalformed, "has an stts shorter than its samples");

    if (const Box* ctts_box = first(boxes, tag("ctts"))) {
      const View ctts = body(stbl, *ctts_box, "ctts");
      const uint32_t m = ctts.u32(4);
      ctts.need(8, 8 * (int64_t)m);
      i = 0;
      for (uint32_t e = 0; e < m; e++)
        for (uint32_t k = 0, count = ctts.u32(8 + 8 * e); k < count && i < n; k++, i++)
          samples[(size_t)i].cto = (int32_t)ctts.u32(12 + 8 * e);
      if (i != n) fail(kMalformed, "has a ctts shorter than its samples");
    }

    if (const Box* stss_box = first(boxes, tag("stss"))) {
      const View stss = body(stbl, *stss_box, "stss");
      const uint32_t m = stss.u32(4);
      stss.need(8, 4 * (int64_t)m);
      for (Sample& s : samples) s.key = false;
      for (uint32_t e = 0; e < m; e++) {
        const int64_t k = (int64_t)stss.u32(8 + 4 * e) - 1;
        if (k < 0 || k >= n) fail(kMalformed, "has an stss entry past its samples");
        samples[(size_t)k].key = true;
      }
    }

    std::vector<int64_t> chunks;
    if (co64_box) {
      const View co = body(stbl, *co64_box, "co64");
      const uint32_t m = co.u32(4);
      co.need(8, 8 * (int64_t)m);
      for (uint32_t e = 0; e < m; e++) chunks.push_back((int64_t)co.u64(8 + 8 * e));
    } else {
      const View co = body(stbl, *stco_box, "stco");
      const uint32_t m = co.u32(4);
      co.need(8, 4 * (int64_t)m);
      for (uint32_t e = 0; e < m; e++) chunks.push_back(co.u32(8 + 4 * e));
    }
    const View stsc = body(stbl, *stsc_box, "stsc");
    const uint32_t m = stsc.u32(4);
    stsc.need(8, 12 * (int64_t)m);
    i = 0;
    for (uint32_t e = 0; e < m; e++) {
      const int64_t first_chunk = (int64_t)stsc.u32(8 + 12 * e) - 1;
      const int64_t last_chunk = e + 1 < m ? (int64_t)stsc.u32(8 + 12 * (e + 1)) - 1
                                           : (int64_t)chunks.size();
      const int64_t per = stsc.u32(12 + 12 * e);
      if (first_chunk < 0 || last_chunk > (int64_t)chunks.size() || last_chunk < first_chunk)
        fail(kMalformed, "has an stsc entry past its chunks");
      for (int64_t c = first_chunk; c < last_chunk; c++) {
        int64_t pos = chunks[(size_t)c];
        for (int64_t k = 0; k < per && i < n; k++, i++) {
          samples[(size_t)i].offset = pos;
          pos += samples[(size_t)i].size;
        }
      }
    }
    if (i != n) fail(kMalformed, "has chunks for fewer samples than stsz lists");
  }

  // E, M and D (media timescale) of the leading empty edits and the one
  // media edit; D < 0: no end.
  bool media_edit(int64_t& empty, int64_t& media_time, int64_t& duration) const {
    empty = 0;
    media_time = 0;
    duration = -1;
    size_t i = 0;
    for (; i < edits_.size() && edits_[i].media_time == -1; i++)
      empty += movie_timescale_ > 0 ? rescale(edits_[i].duration, timescale, movie_timescale_) : 0;
    if (i == edits_.size()) return empty > 0;
    media_time = edits_[i].media_time;
    if (edits_[i].duration > 0 && movie_timescale_ > 0)
      duration = rescale(edits_[i].duration, timescale, movie_timescale_);
    if (i + 1 < edits_.size()) fail(kUnsupported, "has an edit list of more than one media edit");
    return true;
  }

  void apply_edit_list() {
    int64_t empty, m, d;
    if (!media_edit(empty, m, d)) {
      for (Sample& s : samples) {
        s.pts = s.dts + s.cto;
        s.shown = true;
      }
      return;
    }
    int64_t least = INT64_MAX;
    for (Sample& s : samples) {
      const int64_t cts = s.dts + s.cto;
      s.shown = cts >= m && (d < 0 || cts < m + d);
      if (s.shown) least = std::min(least, cts);
    }
    if (least == INT64_MAX) fail(kMalformed, "has an edit list that shows no sample");
    for (Sample& s : samples) s.pts = s.dts + s.cto - least + empty;
  }

  void offset_fragments() {
    int64_t empty, m, d;
    const int64_t offset = media_edit(empty, m, d) ? m - empty : 0;
    for (Sample& s : samples) {
      s.pts = s.dts + s.shift + s.cto - offset;
      s.shown = true;
    }
  }

  void parse_moof(const View& moof, int64_t moof_start, int64_t& next_dts) {
    for (const Box& tb : children(moof)) {
      if (tb.type != tag("traf")) continue;
      const View traf = body(moof, tb, "traf");
      const auto boxes = children(traf);
      const Box* tfhd_box = first(boxes, tag("tfhd"));
      if (!tfhd_box) fail(kMalformed, "has a traf without tfhd");
      const View tfhd = body(traf, *tfhd_box, "tfhd");
      const uint32_t flags = tfhd.u32(0) & 0xFFFFFF;
      if (tfhd.u32(4) != track_id_) continue;
      Trex def = trex_.count(track_id_) ? trex_[track_id_] : Trex{};
      int64_t at = 8, base = moof_start;
      if (flags & 0x01) { base = (int64_t)tfhd.u64(at); at += 8; }
      if (flags & 0x02) at += 4;
      if (flags & 0x08) { def.duration = tfhd.u32(at); at += 4; }
      if (flags & 0x10) { def.size = tfhd.u32(at); at += 4; }
      if (flags & 0x20) { def.flags = tfhd.u32(at); at += 4; }
      if (const Box* tfdt_box = first(boxes, tag("tfdt"))) {
        const View v = body(traf, *tfdt_box, "tfdt");
        next_dts = v.u8(0) == 1 ? (int64_t)v.u64(4) : (int64_t)v.u32(4);
      }
      int64_t pos = base;
      for (const Box& rb : boxes) {
        if (rb.type != tag("trun")) continue;
        const View trun = body(traf, rb, "trun");
        const uint32_t tf = trun.u32(0) & 0xFFFFFF;
        const int64_t n = trun.u32(4);
        int64_t k = 8;
        if (tf & 0x001) { pos = base + (int32_t)trun.u32(k); k += 4; }
        uint32_t first_flags = def.flags;
        const bool has_first = tf & 0x004;
        if (has_first) { first_flags = trun.u32(k); k += 4; }
        const int64_t per = 4 * (!!(tf & 0x100) + !!(tf & 0x200) + !!(tf & 0x400) + !!(tf & 0x800));
        trun.need(k, per * n);
        for (int64_t i = 0; i < n; i++) {
          Sample s{};
          uint32_t duration = def.duration, size = def.size;
          uint32_t sflags = (i == 0 && has_first) ? first_flags : def.flags;
          if (tf & 0x100) { duration = trun.u32(k); k += 4; }
          if (tf & 0x200) { size = trun.u32(k); k += 4; }
          if (tf & 0x400) { sflags = trun.u32(k); k += 4; }
          if (tf & 0x800) {
            // signed in both versions, as libavformat reads them
            s.cto = (int32_t)trun.u32(k);
            k += 4;
          }
          s.offset = pos;
          s.size = size;
          s.dts = next_dts;
          // libavformat: a sample is a key frame unless it is marked
          // non-sync or dependent on others
          s.key = !(sflags & 0x01010000u);
          pos += size;
          next_dts += duration;
          samples.push_back(s);
        }
      }
    }
  }
};

void copy_error(const Failure& f, int32_t* code, char* err, int err_len) {
  if (code) *code = f.code;
  if (err && err_len > 0) std::snprintf(err, (size_t)err_len, "%s", f.what.c_str());
}

}  // namespace

extern "C" {

void* vdqn_mp4_open(const char* path, int32_t* code, char* err, int err_len) {
  try {
    *code = kOk;
    return new Demuxer(path);
  } catch (const Failure& f) {
    copy_error(f, code, err, err_len);
  } catch (const std::bad_alloc&) {
    copy_error(Failure{kMalformed, "needs more memory than there is (malformed sizes?)"}, code,
               err, err_len);
  }
  return nullptr;
}

void vdqn_mp4_info(void* h, int64_t* info) {
  const Demuxer* d = static_cast<Demuxer*>(h);
  info[0] = (int64_t)d->samples.size();
  info[1] = d->timescale;
  info[2] = d->width;
  info[3] = d->height;
  info[4] = d->nal_size;
  info[5] = d->entry;
}

void vdqn_mp4_samples(void* h, int64_t* pts, int64_t* dts, uint8_t* key, uint8_t* shown,
                      int64_t* bound) {
  const Demuxer* d = static_cast<Demuxer*>(h);
  for (size_t i = 0; i < d->samples.size(); i++) {
    const Sample& s = d->samples[i];
    pts[i] = s.pts;
    dts[i] = s.dts;
    key[i] = s.key;
    shown[i] = s.shown;
    bound[i] = d->bound(s);
  }
}

int64_t vdqn_mp4_read(void* h, int64_t first, int64_t count, uint8_t* out, int64_t capacity,
                      int64_t* ends, int32_t* code, char* err, int err_len) {
  Demuxer* d = static_cast<Demuxer*>(h);
  try {
    *code = kOk;
    if (first < 0 || count < 0 || first + count > (int64_t)d->samples.size())
      fail(kMalformed, "sample range out of bounds");
    return d->read(first, count, out, capacity, ends);
  } catch (const Failure& f) {
    copy_error(f, code, err, err_len);
  }
  return -1;
}

void vdqn_mp4_close(void* h) { delete static_cast<Demuxer*>(h); }

}  // extern "C"
