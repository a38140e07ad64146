// H.264 decoder for frame extraction, written from ITU-T H.264 (the
// decoding process of clauses 7 to 9) with no codec library: the decoder
// half of the JAX package's libavcodec stage (native/decode/decode.cc),
// which the card's machine does not have. Its driver's NVDEC engines are not
// exposed to programs there either (cuvidGetDecoderCaps and
// cuvidCreateDecoder fail), so decoding runs on the host; only the kept
// frames go on to the card, where csrc/nv12_rgb.cu converts them.
//
// H.264 decoding is exact: a conforming decoder's pictures equal
// libavcodec's bit for bit, and tests/test_torch_h264.py holds this one to
// libavcodec's planes. What it decodes: progressive (frame_mbs_only) 8-bit
// 4:2:0 streams with CABAC entropy coding, as YouTube's and x264's High,
// Main profile streams are: I, P and B slices (several a picture), all
// macroblock types and partitions, intra 4x4, 8x8 and 16x16 prediction,
// the 8x8 transform and scaling matrices, quarter-sample motion
// compensation with explicit and implicit weighted prediction, spatial and
// temporal direct prediction, long-term references and every memory
// management operation, picture order count types 0, 1 and 2, and the
// deblocking filter. What it refuses, raising with the reason: CAVLC
// (entropy_coding_mode_flag 0), interlaced coding (field pictures and
// MBAFF), other chroma formats and bit depths, lossless (transform bypass)
// macroblocks, slice groups, data partitioning, SP/SI slices and gaps in
// frame_num.
//
// Pictures are returned in decoding order; the caller orders them for
// display by the container's timestamps (data/h264.py).
//
// C ABI (ctypes; video_dqn_tpu_torch/data/h264.py):
//   void* vdqn_h264_open(void);
//   int vdqn_h264_decode(void* h, const uint8_t* au, int64_t size, int64_t tag,
//                        char* err, int err_len);
//       decodes one access unit (Annex B: start codes, the SPS and PPS
//       before an IDR), 0 or a status with the reason in err: 2 malformed,
//       3 not supported. The picture is kept under `tag` until released.
//   int vdqn_h264_info(void* h, int64_t tag, int32_t* info);
//       the picture's display width and height (after cropping), coded
//       width and height, video_full_range_flag; 0, or -1 for an unknown
//       tag
//   int vdqn_h264_copy(void* h, int64_t tag, uint8_t* y, int64_t y_pitch,
//                      uint8_t* uv, int64_t uv_pitch);
//       the picture's display area as NV12 (interleaved Cb, Cr); 0, or -1
//       for an unknown tag
//   void vdqn_h264_release(void* h, int64_t tag);
//   void vdqn_h264_close(void* h);

#include <algorithm>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <memory>
#include <string>
#include <vector>

#include "h264_tables.h"

namespace h264 {
namespace {

enum Code { kOk = 0, kMalformed = 2, kUnsupported = 3 };

struct Failure {
  int code;
  std::string what;
};

[[noreturn]] void fail(int code, const std::string& what) { throw Failure{code, what}; }
[[noreturn]] void unsupported(const std::string& what) { fail(kUnsupported, what + " is not supported"); }
[[noreturn]] void malformed(const std::string& what) { fail(kMalformed, what); }

inline int clip3(int lo, int hi, int v) { return v < lo ? lo : (v > hi ? hi : v); }
inline uint8_t clip1(int v) { return (uint8_t)(v < 0 ? 0 : (v > 255 ? 255 : v)); }
inline int median3(int a, int b, int c) { return std::max(std::min(a, b), std::min(std::max(a, b), c)); }

// ---------------------------------------------------------------------------
// Bit reader over an RBSP (emulation prevention bytes removed)

struct Bits {
  const uint8_t* p = nullptr;
  int64_t bytes = 0;
  int64_t pos = 0;  // in bits

  uint32_t bit() {
    if (pos >= bytes * 8) malformed("a NAL unit ends inside its syntax (truncated)");
    const uint32_t b = (p[pos >> 3] >> (7 - (pos & 7))) & 1;
    pos++;
    return b;
  }
  uint32_t u(int n) {
    uint32_t v = 0;
    for (int i = 0; i < n; i++) v = (v << 1) | bit();
    return v;
  }
  uint32_t ue() {
    int zeros = 0;
    while (bit() == 0) {
      if (++zeros > 31) malformed("an Exp-Golomb code is longer than 32 bits");
    }
    return (uint32_t)(((uint64_t)1 << zeros) - 1 + u(zeros));
  }
  int32_t se() {
    const uint32_t k = ue();
    return (k & 1) ? (int32_t)((k + 1) / 2) : -(int32_t)(k / 2);
  }
  bool byte_aligned() const { return (pos & 7) == 0; }
  // more_rbsp_data(): anything before the rbsp_stop_one_bit
  bool more_rbsp_data() const {
    int64_t last = bytes - 1;
    while (last >= 0 && p[last] == 0) last--;
    if (last < 0) return false;
    const int trailing = __builtin_ctz(p[last]);
    const int64_t stop = last * 8 + (7 - trailing);
    return pos < stop;
  }
};

// ---------------------------------------------------------------------------
// Parameter sets

// zig-zag (frame) scans, raster index row * N + column
constexpr uint8_t kZigzag4[16] = {0, 1, 4, 8, 5, 2, 3, 6, 9, 12, 13, 10, 7, 11, 14, 15};
constexpr uint8_t kZigzag8[64] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,  12, 19, 26, 33, 40, 48,
    41, 34, 27, 20, 13, 6,  7,  14, 21, 28, 35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23,
    30, 37, 44, 51, 58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63};
// Table 7-3 and 7-4 default scaling lists, in zig-zag order
constexpr uint8_t kDefault4Intra[16] = {6, 13, 13, 20, 20, 20, 28, 28, 28, 28, 32, 32, 32, 37, 37, 42};
constexpr uint8_t kDefault4Inter[16] = {10, 14, 14, 20, 20, 20, 24, 24, 24, 24, 27, 27, 27, 30, 30, 34};
constexpr uint8_t kDefault8Intra[64] = {
    6,  10, 10, 13, 11, 13, 16, 16, 16, 16, 18, 18, 18, 18, 18, 23, 23, 23, 23, 23, 23, 25,
    25, 25, 25, 25, 25, 25, 27, 27, 27, 27, 27, 27, 27, 27, 29, 29, 29, 29, 29, 29, 29, 31,
    31, 31, 31, 31, 31, 33, 33, 33, 33, 33, 36, 36, 36, 36, 38, 38, 38, 40, 40, 42};
constexpr uint8_t kDefault8Inter[64] = {
    9,  13, 13, 15, 13, 15, 17, 17, 17, 17, 19, 19, 19, 19, 19, 21, 21, 21, 21, 21, 21, 22,
    22, 22, 22, 22, 22, 22, 24, 24, 24, 24, 24, 24, 24, 24, 25, 25, 25, 25, 25, 25, 25, 27,
    27, 27, 27, 27, 27, 28, 28, 28, 28, 28, 30, 30, 30, 30, 32, 32, 32, 33, 33, 35};

// Scaling lists in zig-zag order: six 4x4 (Intra Y, Cb, Cr, Inter Y, Cb,
// Cr) and two 8x8 (Intra Y, Inter Y).
struct ScalingLists {
  uint8_t l4[6][16];
  uint8_t l8[2][64];
};

void flat_lists(ScalingLists& s) {
  std::memset(s.l4, 16, sizeof(s.l4));
  std::memset(s.l8, 16, sizeof(s.l8));
}

// scaling_list() syntax; returns false where useDefaultScalingMatrixFlag
bool read_scaling_list(Bits& b, uint8_t* list, int size) {
  int last = 8, next = 8;
  for (int j = 0; j < size; j++) {
    if (next != 0) {
      const int delta = b.se();
      if (delta < -128 || delta > 127) malformed("a scaling list delta is out of range");
      next = (last + delta + 256) % 256;
      if (j == 0 && next == 0) return false;
    }
    list[j] = (uint8_t)(next == 0 ? last : next);
    last = list[j];
  }
  return true;
}

// The lists of an SPS (fallback rule A, `fallback` null) or a PPS (rule B,
// `fallback` the SPS's lists).
void read_scaling_lists(Bits& b, ScalingLists& s, int count, const ScalingLists* fallback) {
  for (int i = 0; i < count; i++) {
    const bool present = b.u(1);
    if (i < 6) {
      const uint8_t* def = i < 3 ? kDefault4Intra : kDefault4Inter;
      if (!present) {  // fall back
        if (i == 0 || i == 3)
          std::memcpy(s.l4[i], fallback ? fallback->l4[i] : def, 16);
        else
          std::memcpy(s.l4[i], s.l4[i - 1], 16);
      } else if (!read_scaling_list(b, s.l4[i], 16)) {
        std::memcpy(s.l4[i], def, 16);
      }
    } else {
      const int k = i - 6;
      const uint8_t* def = k == 0 ? kDefault8Intra : kDefault8Inter;
      if (!present)
        std::memcpy(s.l8[k], fallback ? fallback->l8[k] : def, 64);
      else if (!read_scaling_list(b, s.l8[k], 64))
        std::memcpy(s.l8[k], def, 64);
    }
  }
}

struct Sps {
  bool valid = false;
  int profile_idc = 0;
  int chroma_format_idc = 1;
  int log2_max_frame_num = 4;
  int poc_type = 0;
  int log2_max_poc_lsb = 4;
  bool delta_pic_order_always_zero = false;
  int offset_for_non_ref_pic = 0;
  int offset_for_top_to_bottom_field = 0;
  std::vector<int> offset_for_ref_frame;
  int max_num_ref_frames = 0;
  bool gaps_allowed = false;
  int width_mbs = 0, height_mbs = 0;
  bool direct_8x8_inference = false;
  int crop_left = 0, crop_right = 0, crop_top = 0, crop_bottom = 0;  // luma samples
  bool scaling_present = false;
  ScalingLists scaling;
  bool full_range = false;
};

struct Pps {
  bool valid = false;
  int sps_id = 0;
  bool bottom_field_pic_order_present = false;
  int num_ref_idx_default[2] = {1, 1};
  bool weighted_pred = false;
  int weighted_bipred_idc = 0;
  int pic_init_qp = 26;
  int chroma_qp_offset[2] = {0, 0};
  bool deblocking_control = false;
  bool constrained_intra_pred = false;
  bool redundant_pic_cnt_present = false;
  bool transform_8x8_mode = false;
  bool scaling_present = false;
  ScalingLists scaling;  // the lists in force (SPS's, PPS's or flat)
};

void parse_sps(Bits& b, std::vector<Sps>& table) {
  Sps s;
  s.profile_idc = b.u(8);
  b.u(8);  // constraint flags, reserved
  b.u(8);  // level_idc
  const uint32_t id = b.ue();
  if (id > 31) malformed("seq_parameter_set_id > 31");
  flat_lists(s.scaling);
  const int p = s.profile_idc;
  if (p == 100 || p == 110 || p == 122 || p == 244 || p == 44 || p == 83 || p == 86 || p == 118 ||
      p == 128 || p == 138 || p == 139 || p == 134 || p == 135) {
    s.chroma_format_idc = b.ue();
    if (s.chroma_format_idc == 3) b.u(1);  // separate_colour_plane_flag
    const int depth_luma = b.ue() + 8, depth_chroma = b.ue() + 8;
    if (depth_luma != 8 || depth_chroma != 8)
      unsupported("a bit depth of " + std::to_string(depth_luma) + "/" + std::to_string(depth_chroma));
    if (b.u(1)) unsupported("lossless coding (qpprime_y_zero_transform_bypass_flag)");
    s.scaling_present = b.u(1);
    if (s.scaling_present) read_scaling_lists(b, s.scaling, s.chroma_format_idc != 3 ? 8 : 12, nullptr);
  }
  if (s.chroma_format_idc != 1)
    unsupported("chroma_format_idc " + std::to_string(s.chroma_format_idc) + " (only 4:2:0)");
  s.log2_max_frame_num = b.ue() + 4;
  if (s.log2_max_frame_num > 16) malformed("log2_max_frame_num > 16");
  s.poc_type = b.ue();
  if (s.poc_type == 0) {
    s.log2_max_poc_lsb = b.ue() + 4;
    if (s.log2_max_poc_lsb > 16) malformed("log2_max_pic_order_cnt_lsb > 16");
  } else if (s.poc_type == 1) {
    s.delta_pic_order_always_zero = b.u(1);
    s.offset_for_non_ref_pic = b.se();
    s.offset_for_top_to_bottom_field = b.se();
    const uint32_t n = b.ue();
    if (n > 255) malformed("num_ref_frames_in_pic_order_cnt_cycle > 255");
    for (uint32_t i = 0; i < n; i++) s.offset_for_ref_frame.push_back(b.se());
  } else if (s.poc_type != 2) {
    malformed("pic_order_cnt_type " + std::to_string(s.poc_type));
  }
  s.max_num_ref_frames = b.ue();
  if (s.max_num_ref_frames > 16) malformed("max_num_ref_frames > 16");
  s.gaps_allowed = b.u(1);
  s.width_mbs = b.ue() + 1;
  s.height_mbs = b.ue() + 1;
  if (!b.u(1)) unsupported("interlaced coding (frame_mbs_only_flag 0)");
  if (s.width_mbs > 1024 || s.height_mbs > 1024) malformed("a picture larger than 16384 samples");
  s.direct_8x8_inference = b.u(1);
  if (b.u(1)) {  // frame_cropping_flag, 4:2:0 frames: units of 2 samples
    s.crop_left = 2 * b.ue();
    s.crop_right = 2 * b.ue();
    s.crop_top = 2 * b.ue();
    s.crop_bottom = 2 * b.ue();
    if (s.crop_left + s.crop_right >= 16 * s.width_mbs ||
        s.crop_top + s.crop_bottom >= 16 * s.height_mbs)
      malformed("the cropping window is empty");
  }
  if (b.u(1)) {  // vui_parameters_present_flag: read as far as the range flag
    if (b.u(1)) {  // aspect_ratio_info_present_flag
      if (b.u(8) == 255) {
        b.u(16);
        b.u(16);
      }
    }
    if (b.u(1)) b.u(1);  // overscan
    if (b.u(1)) {        // video_signal_type_present_flag
      b.u(3);
      s.full_range = b.u(1);
    }
  }
  s.valid = true;
  table[id] = s;
}

void parse_pps(Bits& b, std::vector<Pps>& table, const std::vector<Sps>& sps) {
  Pps q;
  const uint32_t id = b.ue();
  if (id > 255) malformed("pic_parameter_set_id > 255");
  q.sps_id = b.ue();
  if (q.sps_id > 31 || !sps[q.sps_id].valid) malformed("a PPS names a missing SPS");
  if (!b.u(1)) unsupported("CAVLC entropy coding (entropy_coding_mode_flag 0)");
  q.bottom_field_pic_order_present = b.u(1);
  if (b.ue() != 0) unsupported("slice groups (FMO)");
  q.num_ref_idx_default[0] = b.ue() + 1;
  q.num_ref_idx_default[1] = b.ue() + 1;
  if (q.num_ref_idx_default[0] > 32 || q.num_ref_idx_default[1] > 32)
    malformed("num_ref_idx_default_active > 32");
  q.weighted_pred = b.u(1);
  q.weighted_bipred_idc = b.u(2);
  q.pic_init_qp = 26 + b.se();
  b.se();  // pic_init_qs
  q.chroma_qp_offset[0] = q.chroma_qp_offset[1] = b.se();
  q.deblocking_control = b.u(1);
  q.constrained_intra_pred = b.u(1);
  q.redundant_pic_cnt_present = b.u(1);
  const Sps& s = sps[q.sps_id];
  q.scaling = s.scaling;
  if (b.more_rbsp_data()) {
    q.transform_8x8_mode = b.u(1);
    q.scaling_present = b.u(1);
    if (q.scaling_present) {
      // rule B falls back to the SPS's lists, or to rule A's defaults
      // where the SPS has none
      ScalingLists fallback;
      if (s.scaling_present) {
        fallback = s.scaling;
      } else {
        for (int i = 0; i < 6; i++) std::memcpy(fallback.l4[i], i < 3 ? kDefault4Intra : kDefault4Inter, 16);
        std::memcpy(fallback.l8[0], kDefault8Intra, 64);
        std::memcpy(fallback.l8[1], kDefault8Inter, 64);
      }
      read_scaling_lists(b, q.scaling, 6 + 2 * q.transform_8x8_mode, &fallback);
    }
    q.chroma_qp_offset[1] = b.se();
  }
  q.valid = true;
  table[id] = q;
}

// ---------------------------------------------------------------------------
// Pictures

struct Picture {
  int id = 0;  // unique in the decoder's life
  int width_mbs = 0, height_mbs = 0;
  std::vector<uint8_t> y, cb, cr;  // coded size, stride 16 * width_mbs (chroma half)
  int poc = 0;
  int frame_num = 0;
  int frame_num_wrap = 0;
  bool short_term = false, long_term = false;
  int long_term_frame_idx = 0;
  bool mmco5 = false;
  // per 4x4 block (raster over the picture): motion for later pictures'
  // direct prediction
  std::vector<int16_t> mv[2];     // x, y pairs
  std::vector<int8_t> ref_idx[2];
  std::vector<int> ref_id[2];     // the id of the referenced picture
  std::vector<uint8_t> mb_intra;  // per macroblock
  int64_t tag = 0;
  bool held = false;  // by the caller until released
  int crop[4] = {0, 0, 0, 0};
  bool full_range = false;

  bool is_ref() const { return short_term || long_term; }
  int stride() const { return 16 * width_mbs; }
  int cstride() const { return 8 * width_mbs; }
};

void allocate(Picture& p, int w_mbs, int h_mbs) {
  p.width_mbs = w_mbs;
  p.height_mbs = h_mbs;
  const size_t luma = (size_t)256 * w_mbs * h_mbs, blocks = (size_t)16 * w_mbs * h_mbs;
  p.y.assign(luma, 0);
  p.cb.assign(luma / 4, 0);
  p.cr.assign(luma / 4, 0);
  for (int l = 0; l < 2; l++) {
    p.mv[l].assign(2 * blocks, 0);
    p.ref_idx[l].assign(blocks, -1);
    p.ref_id[l].assign(blocks, -1);
  }
  p.mb_intra.assign((size_t)w_mbs * h_mbs, 0);
}

// ---------------------------------------------------------------------------
// Slices

enum SliceType { kP = 0, kB = 1, kI = 2 };

struct Weights {
  int luma_log2 = 0, chroma_log2 = 0;
  // [list][ref] {weight, offset} for Y, Cb, Cr; flag: explicit present
  int w[2][32][3];
  int o[2][32][3];
};

struct Slice {
  int type = kI;
  int nal_ref_idc = 0;
  bool idr = false;
  int pps_id = 0;
  int first_mb = 0;
  int frame_num = 0;
  int idr_pic_id = 0;
  int poc_lsb = 0;
  int delta_poc_bottom = 0;
  int delta_poc[2] = {0, 0};
  bool direct_spatial = true;
  int num_ref_idx[2] = {0, 0};
  int cabac_init_idc = 0;
  int qp = 26;
  int disable_deblocking = 0;
  int alpha_offset = 0, beta_offset = 0;
  bool long_term_reference_flag = false;
  bool adaptive_marking = false;
  std::vector<std::pair<int, std::pair<int, int>>> mmco;  // op, (arg1, arg2)
  // ref_pic_list_modification: (idc, value)
  std::vector<std::pair<int, int>> modification[2];
  bool explicit_wp = false;
  bool implicit_wp = false;
  Weights wp;
  Picture* ref_list[2][32] = {};
  // implicit weights [ref0][ref1] -> w0 (w1 = 64 - w0), 32 where default
  int implicit_w[32][32];
};

// ---------------------------------------------------------------------------
// Macroblock state kept for neighbours, direct prediction and deblocking

struct MbInfo {
  int slice = -1;  // index of its slice in the current picture, -1 not yet decoded
  bool intra = false, skip = false, pcm = false, i16 = false, inxn = false;
  bool direct16 = false;  // B_Skip or B_Direct_16x16
  bool t8x8 = false;
  bool uniform = false;   // inter, one motion for all 16 blocks
  uint8_t cbp = 0;        // CodedBlockPatternLuma | CodedBlockPatternChroma << 4
  uint8_t dc_cbf = 0;     // coded_block_flag: luma DC bit 0, Cb DC bit 1, Cr DC bit 2
  uint8_t chroma_pred = 0;
  int qp = 0;             // QPY for deblocking (0 for I_PCM)
  int8_t intra_modes[16];  // Intra4x4/8x8 modes by 4x4 raster block, 2 elsewhere
  uint8_t nnz[16];         // luma non-zero coefficients by 4x4 raster block
  uint8_t nnz_c[2][4];     // chroma AC by component and block
  uint8_t mvd[2][16][2];   // |mvd| by list, 4x4 raster block, component (clamped)
  int8_t ref[2][4];        // refIdx by list and 8x8 partition, -1: list unused
  uint8_t direct8[4];      // 8x8 partition predicted directly

  void reset() {
    intra = skip = pcm = i16 = inxn = direct16 = t8x8 = uniform = false;
    cbp = dc_cbf = chroma_pred = 0;
    std::memset(intra_modes, 2, sizeof(intra_modes));
    std::memset(nnz, 0, sizeof(nnz));
    std::memset(nnz_c, 0, sizeof(nnz_c));
    std::memset(mvd, 0, sizeof(mvd));
    std::memset(ref, -1, sizeof(ref));
    std::memset(direct8, 0, sizeof(direct8));
  }
};

constexpr int kChromaQp[52] = {0,  1,  2,  3,  4,  5,  6,  7,  8,  9,  10, 11, 12, 13, 14, 15, 16, 17,
                               18, 19, 20, 21, 22, 23, 24, 25, 26, 27, 28, 29, 29, 30, 31, 32, 32, 33,
                               34, 34, 35, 35, 36, 36, 37, 37, 37, 38, 38, 38, 39, 39, 39, 39};
constexpr uint8_t kTransIdxLps[64] = {
    0,  0,  1,  2,  2,  4,  4,  5,  6,  7,  8,  9,  9,  11, 11, 12, 13, 13, 15, 15, 16, 16,
    18, 18, 19, 19, 21, 21, 22, 22, 23, 24, 24, 25, 26, 26, 27, 27, 28, 29, 29, 30, 30, 30,
    31, 32, 32, 33, 33, 33, 34, 34, 35, 35, 35, 36, 36, 36, 37, 37, 37, 38, 38, 63};
// Table 9-43: significant_coeff_flag and last_significant_coeff_flag
// ctxIdxInc of 8x8 blocks in frames
constexpr uint8_t kSig8x8[63] = {0,  1,  2,  3,  4,  5,  5,  4,  4,  3,  3,  4,  4,  4,  5,  5,
                                 4,  4,  4,  4,  3,  3,  6,  7,  7,  7,  8,  9,  10, 9,  8,  7,
                                 7,  6,  11, 12, 13, 11, 6,  7,  8,  9,  14, 10, 9,  8,  6,  11,
                                 12, 13, 11, 6,  9,  14, 10, 9,  11, 12, 13, 11, 14, 10, 12};
constexpr uint8_t kLast8x8[63] = {0, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 2, 2, 2, 2, 2,
                                  2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 3, 3, 3, 3, 3, 3, 3, 3, 4, 4,
                                  4, 4, 4, 4, 4, 4, 5, 5, 5, 5, 6, 6, 6, 6, 7, 7, 7, 7, 8, 8, 8};
// luma4x4BlkIdx -> raster 4x4 block (row * 4 + column)
constexpr uint8_t kBlkToRaster[16] = {0, 1, 4, 5, 2, 3, 6, 7, 8, 9, 12, 13, 10, 11, 14, 15};

// B macroblock types 1..21 (Table 7-14): partition prediction (1 L0, 2 L1,
// 3 Bi) of partitions 0 and 1; 16x16 for 1..3, then 16x8 (even) / 8x16 (odd)
constexpr uint8_t kBPred[22][2] = {{0, 0}, {1, 0}, {2, 0}, {3, 0}, {1, 1}, {1, 1}, {2, 2}, {2, 2},
                                   {1, 2}, {1, 2}, {2, 1}, {2, 1}, {1, 3}, {1, 3}, {2, 3}, {2, 3},
                                   {3, 1}, {3, 1}, {3, 2}, {3, 2}, {3, 3}, {3, 3}};
// B sub-macroblock types (Table 7-18): prediction, then the partition shape
// (0 8x8, 1 8x4, 2 4x8, 3 4x4)
constexpr uint8_t kBSubPred[13] = {0, 1, 2, 3, 1, 1, 2, 2, 3, 3, 1, 2, 3};
constexpr uint8_t kBSubShape[13] = {0, 0, 0, 0, 1, 2, 1, 2, 1, 2, 3, 3, 3};

class Decoder {
 public:
  Decoder() : sps_(32), pps_(256) {}

  void decode_au(const uint8_t* data, int64_t size, int64_t tag);
  Picture* find(int64_t tag) {
    for (auto& p : pics_)
      if (p->held && p->tag == tag) return p.get();
    return nullptr;
  }
  void release(int64_t tag) {
    if (Picture* p = find(tag)) p->held = false;
    collect();
  }

 private:
  std::vector<Sps> sps_;
  std::vector<Pps> pps_;
  std::vector<std::unique_ptr<Picture>> pics_;
  std::vector<std::unique_ptr<Picture>> free_;  // unused pictures, kept for their buffers
  Picture* cur_ = nullptr;
  const Sps* sps_cur_ = nullptr;
  int next_id_ = 1;
  // picture order count and frame_num state (8.2.1)
  int prev_poc_msb_ = 0, prev_poc_lsb_ = 0;
  int prev_frame_num_offset_ = 0, prev_frame_num_ = 0;
  int prev_ref_frame_num_ = 0;
  bool prev_mmco5_ = false, have_prev_ = false;
  int frame_num_offset_ = 0;
  int max_long_term_idx_ = -1;  // -1: no long-term frame indices
  std::vector<Slice> slices_;
  std::vector<MbInfo> mbs_;
  std::vector<uint8_t> nal_;
  // the slice being decoded
  Slice* sl_ = nullptr;
  const Pps* pps_cur_ = nullptr;
  int slice_idx_ = 0;
  int mbx_ = 0, mby_ = 0, mb_addr_ = 0;
  MbInfo* mb_ = nullptr;
  int qp_ = 26;
  int last_qp_delta_ = 0;
  bool prev_mb_qp_ctx_ = false;
  // CABAC (9.3.1.2)
  Bits bits_;
  uint32_t range_ = 510, offset_ = 0;
  uint8_t state_[kNumContexts];
  // dequantization: LevelScale4x4 [list][qp % 6][raster], 8x8 [list][qp % 6][raster]
  int level4_[6][6][16];
  int level8_[2][6][64];

  void collect();
  void start_picture(const Slice& s, const Sps& sps);
  void finish_picture();
  void parse_slice_header(Bits& b, int nal_type, int nal_ref_idc, Slice& s);
  void compute_poc(const Slice& s, const Sps& sps);
  void build_ref_lists(Slice& s, const Sps& sps);
  void implicit_weights(Slice& s);
  void mark_references(const Slice& s, const Sps& sps);
  void decode_slice(Bits& b, int index);
  void set_level_scale(const Pps& pps);

  // CABAC engine
  void cabac_init();
  void engine_init() {
    range_ = 510;
    offset_ = bits_.u(9);
    if (offset_ >= 510) malformed("a CABAC slice starts with an offset of 510 or more");
  }
  void renorm() {
    while (range_ < 256) {
      range_ <<= 1;
      offset_ = (offset_ << 1) | bits_.bit();
    }
  }
  int decision(int ctx) {
    uint8_t& s = state_[ctx];
    int p = s >> 1, mps = s & 1;
    const uint32_t lps = kRangeLps[p][(range_ >> 6) & 3];
    range_ -= lps;
    int bin;
    if (offset_ >= range_) {
      bin = !mps;
      offset_ -= range_;
      range_ = lps;
      if (p == 0) mps = 1 - mps;
      p = kTransIdxLps[p];
    } else {
      bin = mps;
      if (p < 62) p++;
    }
    s = (uint8_t)(p << 1 | mps);
    renorm();
    return bin;
  }
  int bypass() {
    offset_ = (offset_ << 1) | bits_.bit();
    if (offset_ >= range_) {
      offset_ -= range_;
      return 1;
    }
    return 0;
  }
  int terminate() {
    range_ -= 2;
    if (offset_ >= range_) return 1;
    renorm();
    return 0;
  }

  // neighbours
  const MbInfo* mb_avail(int mbx, int mby) const {
    if (mbx < 0 || mby < 0 || mbx >= cur_->width_mbs || mby >= cur_->height_mbs) return nullptr;
    const MbInfo& m = mbs_[(size_t)mby * cur_->width_mbs + mbx];
    return m.slice == slice_idx_ ? &m : nullptr;
  }
  // the macroblock holding 4x4 block (x, y) relative to the current one
  // (x, y in -1..4) and the block's raster index there; null where not
  // available. The current macroblock counts as available.
  const MbInfo* nb4(int x, int y, int& blk) const {
    int mx = mbx_, my = mby_;
    if (x < 0) { mx--; x += 4; } else if (x > 3) { mx++; x -= 4; }
    if (y < 0) { my--; y += 4; } else if (y > 3) { my++; y -= 4; }
    blk = y * 4 + x;
    if (mx == mbx_ && my == mby_) return mb_;
    return mb_avail(mx, my);
  }

  // syntax elements (9.3.3.1)
  int read_mb_skip();
  int read_mb_type_i(int ctx_base, bool intra_slice);
  int read_mb_type();
  int read_sub_mb_type();
  int read_ref_idx(int list, int x4, int y4);
  int read_mvd(int list, int comp, int x4, int y4);
  int read_cbp();
  int read_qp_delta();
  int read_intra_mode();
  int read_chroma_pred();
  int read_transform_8x8();
  int cbf_ctx_luma(int cat, int x4, int y4);
  int cbf_ctx_dc(int cat, int comp);
  int cbf_ctx_chroma_ac(int comp, int bx, int by);
  int residual_block(int cat, int cbf_ctx, int max_coeff, int* levels);

  // macroblocks
  void decode_mb(bool skip);
  void decode_pcm();
  void intra_modes_nxn(bool t8x8, int* modes);
  void predict_intra16x16(int mode);
  void predict_chroma(int mode);
  void residual_luma(bool i16, int* dc_levels);
  void reconstruct_intra_nxn(const int* modes);
  void chroma_residual();
  // motion
  void mv_neighbour(int list, int x4, int y4, int& ref, int& mvx, int& mvy, bool in_mb_order,
                    int order_cur) const;
  void mv_pred(int list, int ref, int x4, int y4, int w4, int shape, int part, int& px, int& py);
  void set_motion(int list, int x4, int y4, int w4, int h4, int ref, int mvx, int mvy);
  void p_skip_motion();
  void direct_motion(int part8_mask);
  void motion_compensate();
  void inter_block(int x4, int y4, int w4, int h4);

  // per 4x4 block order of the current macroblock's partitions, for
  // availability inside it
  uint8_t part_order_[16];
  // the current macroblock's residual, added after prediction:
  // luma coefficients by 4x4 raster block (or 8x8 block), chroma
  int16_t coef4_[16][16];
  int16_t coef8_[4][64];
  int16_t chroma_dc_[2][4];
  int16_t chroma_ac_[2][4][16];
  bool has_coef4_[16];
  bool has_chroma_ac_[2][4];
};

// ---------------------------------------------------------------------------
// CABAC contexts and syntax elements

void Decoder::cabac_init() {
  const int table = sl_->type == kI ? 0 : 1 + sl_->cabac_init_idc;
  const int qp = clip3(0, 51, sl_->qp);
  for (int i = 0; i < kNumContexts; i++) {
    const int m = kContextInit[table][i][0], n = kContextInit[table][i][1];
    const int pre = clip3(1, 126, ((m * qp) >> 4) + n);
    state_[i] = pre <= 63 ? (uint8_t)((63 - pre) << 1) : (uint8_t)(((pre - 64) << 1) | 1);
  }
}

int Decoder::read_mb_skip() {
  int ctx = 0;
  const MbInfo* a = mb_avail(mbx_ - 1, mby_);
  const MbInfo* b = mb_avail(mbx_, mby_ - 1);
  if (a && !a->skip) ctx++;
  if (b && !b->skip) ctx++;
  return decision((sl_->type == kP ? 11 : 24) + ctx);
}

// the I macroblock types (0 I_NxN, 1..24 I_16x16, 25 I_PCM), from the
// prefix's context base: 3 in I slices, 17 (P) or 32 (B) as a suffix
int Decoder::read_mb_type_i(int ctx_base, bool intra_slice) {
  int base = ctx_base;
  if (intra_slice) {
    int ctx = 0;
    const MbInfo* a = mb_avail(mbx_ - 1, mby_);
    const MbInfo* b = mb_avail(mbx_, mby_ - 1);
    if (a && !a->inxn) ctx++;
    if (b && !b->inxn) ctx++;
    if (!decision(base + ctx)) return 0;
    base += 2;
  } else if (!decision(base)) {
    return 0;
  }
  if (terminate()) return 25;
  const int o = intra_slice ? 1 : 0;
  int t = 1 + 12 * decision(base + 1);
  if (decision(base + 2)) t += 4 + 4 * decision(base + 2 + o);
  t += 2 * decision(base + 3 + o);
  t += decision(base + 3 + 2 * o);
  return t;
}

// P: 0..3 (16x16, 16x8, 8x16, 8x8), 5 + I type. B: 0..22, 23 + I type.
int Decoder::read_mb_type() {
  if (sl_->type == kI) return read_mb_type_i(3, true);
  if (sl_->type == kP) {
    if (!decision(14)) {
      if (!decision(15)) return 3 * decision(16);
      return decision(17) ? 1 : 2;
    }
    return 5 + read_mb_type_i(17, false);
  }
  int ctx = 0;
  const MbInfo* a = mb_avail(mbx_ - 1, mby_);
  const MbInfo* b = mb_avail(mbx_, mby_ - 1);
  if (a && !a->direct16) ctx++;
  if (b && !b->direct16) ctx++;
  if (!decision(27 + ctx)) return 0;
  if (!decision(27 + 3)) return 1 + decision(27 + 5);
  int bits = decision(27 + 4) << 3;
  bits |= decision(27 + 5) << 2;
  bits |= decision(27 + 5) << 1;
  bits |= decision(27 + 5);
  if (bits < 8) return bits + 3;
  if (bits == 13) return 23 + read_mb_type_i(32, false);
  if (bits == 14) return 11;
  if (bits == 15) return 22;
  bits = (bits << 1) | decision(27 + 5);
  return bits - 4;
}

int Decoder::read_sub_mb_type() {
  if (sl_->type == kP) {
    if (decision(21)) return 0;
    if (!decision(22)) return 1;
    return decision(23) ? 2 : 3;
  }
  if (!decision(36)) return 0;
  if (!decision(37)) return 1 + decision(39);
  int t = 3;
  if (decision(38)) {
    if (decision(39)) return 11 + decision(39);
    t += 4;
  }
  t += 2 * decision(39);
  t += decision(39);
  return t;
}

int Decoder::read_ref_idx(int list, int x4, int y4) {
  int ctx = 0;
  for (int n = 0; n < 2; n++) {
    int blk;
    const MbInfo* m = n == 0 ? nb4(x4 - 1, y4, blk) : nb4(x4, y4 - 1, blk);
    if (!m || m->skip || m->intra) continue;
    const int p8 = (blk >> 3) * 2 + ((blk & 3) >> 1);
    if (m->direct8[p8]) continue;
    if (m->ref[list][p8] > 0) ctx += n == 0 ? 1 : 2;
  }
  int ref = 0;
  while (decision(54 + ctx)) {
    ref++;
    ctx = ctx < 4 ? 4 : 5;
    if (ref > 31) malformed("ref_idx > 31");
  }
  return ref;
}

int Decoder::read_mvd(int list, int comp, int x4, int y4) {
  int sum = 0;
  for (int n = 0; n < 2; n++) {
    int blk;
    const MbInfo* m = n == 0 ? nb4(x4 - 1, y4, blk) : nb4(x4, y4 - 1, blk);
    if (m) sum += m->mvd[list][blk][comp];
  }
  const int base = comp == 0 ? 40 : 47;
  if (!decision(base + (sum < 3 ? 0 : (sum <= 32 ? 1 : 2)))) return 0;
  int mvd = 1, ctx = base + 3;
  while (mvd < 9 && decision(ctx)) {
    if (mvd < 4) ctx++;
    mvd++;
  }
  if (mvd >= 9) {
    int k = 3;
    while (bypass()) {
      mvd += 1 << k;
      if (++k > 24) malformed("an mvd is out of range");
    }
    while (k--) mvd += bypass() << k;
  }
  return bypass() ? -mvd : mvd;
}

int Decoder::read_cbp() {
  // luma: condTermFlagN = 0 where N is not available or I_PCM or its
  // 8x8 block's bit is set
  auto bit_a = [&](int b8, int& out) {
    const int y8 = b8 >> 1;
    if (b8 & 1) { out = (mb_->cbp >> (b8 - 1)) & 1; return; }
    const MbInfo* a = mb_avail(mbx_ - 1, mby_);
    if (!a || a->pcm) { out = 1; return; }
    out = a->skip ? 0 : (a->cbp >> (y8 * 2 + 1)) & 1;
  };
  auto bit_b = [&](int b8, int& out) {
    if (b8 >> 1) { out = (mb_->cbp >> (b8 - 2)) & 1; return; }
    const MbInfo* b = mb_avail(mbx_, mby_ - 1);
    if (!b || b->pcm) { out = 1; return; }
    out = b->skip ? 0 : (b->cbp >> (2 + (b8 & 1))) & 1;
  };
  mb_->cbp = 0;
  for (int b8 = 0; b8 < 4; b8++) {
    int a, b;
    bit_a(b8, a);
    bit_b(b8, b);
    const int ctx = (a ? 0 : 1) + (b ? 0 : 2);
    mb_->cbp |= decision(73 + ctx) << b8;
  }
  auto chroma = [&](const MbInfo* m) -> int {
    if (!m) return 0;
    if (m->pcm) return 2;
    if (m->skip) return 0;
    return m->cbp >> 4;
  };
  const int ca = chroma(mb_avail(mbx_ - 1, mby_)), cb = chroma(mb_avail(mbx_, mby_ - 1));
  int c = 0;
  if (decision(77 + (ca > 0) + 2 * (cb > 0))) c = 1 + decision(77 + 4 + (ca == 2) + 2 * (cb == 2));
  mb_->cbp |= c << 4;
  return mb_->cbp;
}

int Decoder::read_qp_delta() {
  int ctx = prev_mb_qp_ctx_ ? 1 : 0;
  int val = 0;
  while (decision(60 + ctx)) {
    ctx = ctx < 2 ? 2 : 3;
    if (++val > 104) malformed("mb_qp_delta out of range");
  }
  return (val & 1) ? (val + 1) / 2 : -(val / 2);
}

int Decoder::read_intra_mode() {
  if (decision(68)) return -1;  // use the predicted mode
  int m = decision(69);
  m |= decision(69) << 1;
  m |= decision(69) << 2;
  return m;
}

int Decoder::read_chroma_pred() {
  int ctx = 0;
  const MbInfo* a = mb_avail(mbx_ - 1, mby_);
  const MbInfo* b = mb_avail(mbx_, mby_ - 1);
  if (a && a->intra && !a->pcm && a->chroma_pred != 0) ctx++;
  if (b && b->intra && !b->pcm && b->chroma_pred != 0) ctx++;
  if (!decision(64 + ctx)) return 0;
  if (!decision(64 + 3)) return 1;
  return decision(64 + 3) ? 3 : 2;
}

int Decoder::read_transform_8x8() {
  int ctx = 0;
  const MbInfo* a = mb_avail(mbx_ - 1, mby_);
  const MbInfo* b = mb_avail(mbx_, mby_ - 1);
  if (a && a->t8x8) ctx++;
  if (b && b->t8x8) ctx++;
  return decision(399 + ctx);
}

// coded_block_flag contexts (9.3.3.1.1.9)
int Decoder::cbf_ctx_luma(int cat, int x4, int y4) {
  int ctx = 0;
  for (int n = 0; n < 2; n++) {
    int blk;
    const MbInfo* m = n == 0 ? nb4(x4 - 1, y4, blk) : nb4(x4, y4 - 1, blk);
    int cond;
    if (!m) cond = mb_->intra ? 1 : 0;
    else if (m->pcm) cond = 1;
    else if (m->skip) cond = 0;
    else if (!((m->cbp >> ((blk >> 3) * 2 + ((blk & 3) >> 1))) & 1)) cond = 0;
    else cond = m->nnz[blk] != 0;
    ctx += cond << n;
  }
  return 85 + (cat == 1 ? 4 : 8) + ctx;
}

int Decoder::cbf_ctx_dc(int cat, int comp) {
  int ctx = 0;
  const MbInfo* nbs[2] = {mb_avail(mbx_ - 1, mby_), mb_avail(mbx_, mby_ - 1)};
  for (int n = 0; n < 2; n++) {
    const MbInfo* m = nbs[n];
    int cond;
    if (!m) cond = mb_->intra ? 1 : 0;
    else if (m->pcm) cond = 1;
    else if (cat == 0) cond = m->i16 ? (m->dc_cbf & 1) : 0;
    else if (m->skip || (m->cbp >> 4) == 0) cond = 0;
    else cond = (m->dc_cbf >> (1 + comp)) & 1;
    ctx += cond << n;
  }
  return 85 + (cat == 0 ? 0 : 12) + ctx;
}

int Decoder::cbf_ctx_chroma_ac(int comp, int bx, int by) {
  int ctx = 0;
  for (int n = 0; n < 2; n++) {
    const int x = n == 0 ? bx - 1 : bx, y = n == 0 ? by : by - 1;
    const MbInfo* m;
    int blk;
    if (x >= 0 && y >= 0) {
      m = mb_;
      blk = y * 2 + x;
    } else {
      m = mb_avail(mbx_ + (x < 0 ? -1 : 0), mby_ + (y < 0 ? -1 : 0));
      blk = (y < 0 ? 1 : y) * 2 + (x < 0 ? 1 : x);
    }
    int cond;
    if (!m) cond = mb_->intra ? 1 : 0;
    else if (m->pcm) cond = 1;
    else if (m->skip || (m->cbp >> 4) != 2) cond = 0;
    else cond = m->nnz_c[comp][blk] != 0;
    ctx += cond << n;
  }
  return 85 + 16 + ctx;
}

// residual_block_cabac: levels in scan order into levels[0..max_coeff);
// returns the count of non-zero levels. cbf_ctx < 0: no coded_block_flag.
int Decoder::residual_block(int cat, int cbf_ctx, int max_coeff, int* levels) {
  std::memset(levels, 0, sizeof(int) * max_coeff);
  if (cbf_ctx >= 0 && !decision(cbf_ctx)) return 0;
  static constexpr int kSigOffset[5] = {0, 15, 29, 44, 47};
  static constexpr int kAbsOffset[5] = {0, 10, 20, 30, 39};
  const int sig_base = cat == 5 ? 402 : 105 + kSigOffset[cat];
  const int last_base = cat == 5 ? 417 : 166 + kSigOffset[cat];
  const int abs_base = cat == 5 ? 426 : 227 + kAbsOffset[cat];
  int index[64];
  int count = 0;
  int i = 0;
  for (; i < max_coeff - 1; i++) {
    const int inc_sig = cat == 5 ? kSig8x8[i] : (cat == 3 ? std::min(i, 2) : i);
    if (decision(sig_base + inc_sig)) {
      index[count++] = i;
      const int inc_last = cat == 5 ? kLast8x8[i] : (cat == 3 ? std::min(i, 2) : i);
      if (decision(last_base + inc_last)) break;
    }
  }
  if (i == max_coeff - 1) index[count++] = i;
  int eq1 = 0, gt1 = 0;
  for (int k = count - 1; k >= 0; k--) {
    const int inc0 = gt1 != 0 ? 0 : std::min(4, 1 + eq1);
    int abs_level;
    if (!decision(abs_base + inc0)) {
      abs_level = 1;
      eq1++;
    } else {
      const int inc = 5 + std::min(4 - (cat == 3 ? 1 : 0), gt1);
      abs_level = 2;
      while (abs_level < 15 && decision(abs_base + inc)) abs_level++;
      if (abs_level >= 15) {
        int j = 0;
        while (bypass()) {
          if (++j > 30) malformed("a coefficient level is out of range");
        }
        int v = 1;
        while (j--) v = 2 * v + bypass();
        abs_level = v + 14;
      }
      gt1++;
    }
    levels[index[k]] = bypass() ? -abs_level : abs_level;
  }
  return count;
}

// ---------------------------------------------------------------------------
// Slice headers, picture order count, reference lists and marking

void Decoder::parse_slice_header(Bits& b, int nal_type, int nal_ref_idc, Slice& s) {
  s.nal_ref_idc = nal_ref_idc;
  s.idr = nal_type == 5;
  s.first_mb = b.ue();
  const uint32_t type = b.ue();
  if (type > 9) malformed("slice_type " + std::to_string(type));
  const int t = type % 5;
  if (t == 3 || t == 4) unsupported("SP and SI slices");
  s.type = t == 0 ? kP : (t == 1 ? kB : kI);
  if (s.idr && s.type != kI) malformed("an IDR picture with a P or B slice");
  s.pps_id = b.ue();
  if (s.pps_id > 255 || !pps_[s.pps_id].valid) malformed("a slice names a missing PPS");
  const Pps& pps = pps_[s.pps_id];
  const Sps& sps = sps_[pps.sps_id];
  s.frame_num = b.u(sps.log2_max_frame_num);
  if (s.idr) s.idr_pic_id = b.ue();
  if (sps.poc_type == 0) {
    s.poc_lsb = b.u(sps.log2_max_poc_lsb);
    if (pps.bottom_field_pic_order_present) s.delta_poc_bottom = b.se();
  } else if (sps.poc_type == 1 && !sps.delta_pic_order_always_zero) {
    s.delta_poc[0] = b.se();
    if (pps.bottom_field_pic_order_present) s.delta_poc[1] = b.se();
  }
  if (pps.redundant_pic_cnt_present && b.ue() != 0) unsupported("redundant pictures");
  if (s.type == kB) s.direct_spatial = b.u(1);
  s.num_ref_idx[0] = s.num_ref_idx[1] = 0;
  if (s.type != kI) {
    s.num_ref_idx[0] = pps.num_ref_idx_default[0];
    s.num_ref_idx[1] = s.type == kB ? pps.num_ref_idx_default[1] : 0;
    if (b.u(1)) {
      s.num_ref_idx[0] = b.ue() + 1;
      if (s.type == kB) s.num_ref_idx[1] = b.ue() + 1;
    }
    // 7.4.3: at most 16 for a frame (32 only for a field, which is refused)
    if (s.num_ref_idx[0] > 16 || s.num_ref_idx[1] > 16) malformed("num_ref_idx_active > 16");
  }
  for (int l = 0; l < (s.type == kB ? 2 : (s.type == kP ? 1 : 0)); l++) {
    s.modification[l].clear();
    if (b.u(1)) {
      for (;;) {
        const uint32_t idc = b.ue();
        if (idc == 3) break;
        if (idc > 2) malformed("modification_of_pic_nums_idc " + std::to_string(idc));
        s.modification[l].push_back({(int)idc, (int)b.ue()});
        if (s.modification[l].size() > 64) malformed("too many reference list modifications");
      }
    }
  }
  s.explicit_wp = (pps.weighted_pred && s.type == kP) || (pps.weighted_bipred_idc == 1 && s.type == kB);
  s.implicit_wp = pps.weighted_bipred_idc == 2 && s.type == kB;
  if (s.explicit_wp) {
    Weights& w = s.wp;
    w.luma_log2 = b.ue();
    w.chroma_log2 = b.ue();
    if (w.luma_log2 > 7 || w.chroma_log2 > 7) malformed("a weight denominator > 2^7");
    for (int l = 0; l < (s.type == kB ? 2 : 1); l++) {
      for (int i = 0; i < s.num_ref_idx[l]; i++) {
        w.w[l][i][0] = 1 << w.luma_log2;
        w.o[l][i][0] = 0;
        if (b.u(1)) {
          w.w[l][i][0] = b.se();
          w.o[l][i][0] = b.se();
        }
        w.w[l][i][1] = w.w[l][i][2] = 1 << w.chroma_log2;
        w.o[l][i][1] = w.o[l][i][2] = 0;
        if (b.u(1)) {
          for (int c = 1; c < 3; c++) {
            w.w[l][i][c] = b.se();
            w.o[l][i][c] = b.se();
          }
        }
      }
    }
  }
  s.adaptive_marking = false;
  s.mmco.clear();
  if (nal_ref_idc != 0) {
    if (s.idr) {
      b.u(1);  // no_output_of_prior_pics_flag
      s.long_term_reference_flag = b.u(1);
    } else {
      s.adaptive_marking = b.u(1);
      if (s.adaptive_marking) {
        for (;;) {
          const uint32_t op = b.ue();
          if (op == 0) break;
          if (op > 6) malformed("memory_management_control_operation " + std::to_string(op));
          int a = 0, c = 0;
          if (op == 1 || op == 3) a = b.ue();
          if (op == 2) a = b.ue();
          if (op == 3 || op == 6) c = b.ue();
          if (op == 4) a = b.ue();
          s.mmco.push_back({(int)op, {a, c}});
          if (s.mmco.size() > 66) malformed("too many memory management operations");
        }
      }
    }
  }
  s.cabac_init_idc = 0;
  if (s.type != kI) {
    s.cabac_init_idc = b.ue();
    if (s.cabac_init_idc > 2) malformed("cabac_init_idc > 2");
  }
  s.qp = pps.pic_init_qp + b.se();
  if (s.qp < 0 || s.qp > 51) malformed("SliceQPY out of range");
  s.disable_deblocking = 0;
  s.alpha_offset = s.beta_offset = 0;
  if (pps.deblocking_control) {
    s.disable_deblocking = b.ue();
    if (s.disable_deblocking > 2) malformed("disable_deblocking_filter_idc > 2");
    if (s.disable_deblocking != 1) {
      s.alpha_offset = 2 * b.se();
      s.beta_offset = 2 * b.se();
    }
  }
}

void Decoder::compute_poc(const Slice& s, const Sps& sps) {
  const int max_frame_num = 1 << sps.log2_max_frame_num;
  int top = 0, bottom = 0;
  if (sps.poc_type == 0) {
    if (s.idr) {
      prev_poc_msb_ = prev_poc_lsb_ = 0;
    }
    const int max_lsb = 1 << sps.log2_max_poc_lsb;
    int msb;
    if (s.poc_lsb < prev_poc_lsb_ && prev_poc_lsb_ - s.poc_lsb >= max_lsb / 2)
      msb = prev_poc_msb_ + max_lsb;
    else if (s.poc_lsb > prev_poc_lsb_ && s.poc_lsb - prev_poc_lsb_ > max_lsb / 2)
      msb = prev_poc_msb_ - max_lsb;
    else
      msb = prev_poc_msb_;
    top = msb + s.poc_lsb;
    bottom = top + s.delta_poc_bottom;
    if (s.nal_ref_idc != 0) {  // this picture's values become prev* (after mmco5: below)
      prev_poc_msb_ = msb;
      prev_poc_lsb_ = s.poc_lsb;
    }
  } else {
    if (s.idr)
      frame_num_offset_ = 0;
    else if (prev_frame_num_ > s.frame_num)
      frame_num_offset_ = prev_frame_num_offset_ + max_frame_num;
    else
      frame_num_offset_ = prev_frame_num_offset_;
    if (sps.poc_type == 1) {
      const int cycle = (int)sps.offset_for_ref_frame.size();
      int abs_frame_num = cycle != 0 ? frame_num_offset_ + s.frame_num : 0;
      if (s.nal_ref_idc == 0 && abs_frame_num > 0) abs_frame_num--;
      int expected = 0;
      if (abs_frame_num > 0) {
        int delta_cycle = 0;
        for (int v : sps.offset_for_ref_frame) delta_cycle += v;
        const int cycle_cnt = (abs_frame_num - 1) / cycle;
        const int in_cycle = (abs_frame_num - 1) % cycle;
        expected = cycle_cnt * delta_cycle;
        for (int i = 0; i <= in_cycle; i++) expected += sps.offset_for_ref_frame[(size_t)i];
      }
      if (s.nal_ref_idc == 0) expected += sps.offset_for_non_ref_pic;
      top = expected + s.delta_poc[0];
      bottom = top + sps.offset_for_top_to_bottom_field + s.delta_poc[1];
    } else {
      const int temp = s.idr ? 0 : (s.nal_ref_idc == 0 ? 2 * (frame_num_offset_ + s.frame_num) - 1
                                                       : 2 * (frame_num_offset_ + s.frame_num));
      top = bottom = temp;
    }
  }
  cur_->poc = std::min(top, bottom);
}

// The reference picture lists of slice s (8.2.4), initialised and modified.
void Decoder::build_ref_lists(Slice& s, const Sps& sps) {
  const int max_frame_num = 1 << sps.log2_max_frame_num;
  std::vector<Picture*> shorts, longs;
  for (auto& p : pics_) {
    if (p.get() == cur_) continue;
    if (p->short_term) {
      p->frame_num_wrap = p->frame_num > s.frame_num ? p->frame_num - max_frame_num : p->frame_num;
      shorts.push_back(p.get());
    } else if (p->long_term) {
      longs.push_back(p.get());
    }
  }
  std::sort(longs.begin(), longs.end(),
            [](const Picture* a, const Picture* b) { return a->long_term_frame_idx < b->long_term_frame_idx; });
  std::vector<Picture*> init[2];
  if (s.type == kP) {
    std::sort(shorts.begin(), shorts.end(),
              [](const Picture* a, const Picture* b) { return a->frame_num_wrap > b->frame_num_wrap; });
    init[0] = shorts;
    init[0].insert(init[0].end(), longs.begin(), longs.end());
  } else if (s.type == kB) {
    std::vector<Picture*> before, after;
    for (Picture* p : shorts) (p->poc < cur_->poc ? before : after).push_back(p);
    std::sort(before.begin(), before.end(), [](const Picture* a, const Picture* b) { return a->poc > b->poc; });
    std::sort(after.begin(), after.end(), [](const Picture* a, const Picture* b) { return a->poc < b->poc; });
    init[0] = before;
    init[0].insert(init[0].end(), after.begin(), after.end());
    init[0].insert(init[0].end(), longs.begin(), longs.end());
    init[1] = after;
    init[1].insert(init[1].end(), before.begin(), before.end());
    init[1].insert(init[1].end(), longs.begin(), longs.end());
    if (init[1].size() > 1 && init[0] == init[1]) std::swap(init[1][0], init[1][1]);
  }
  for (int l = 0; l < 2; l++) {
    // one slot past the list: the modification's shift moves its last entry there
    std::vector<Picture*> list(33, nullptr);
    for (int i = 0; i < s.num_ref_idx[l] && i < (int)init[l].size(); i++) list[(size_t)i] = init[l][(size_t)i];
    // modification (8.2.4.3)
    int pred = s.frame_num, idx = 0;
    for (auto [idc, value] : s.modification[l]) {
      Picture* target = nullptr;
      if (idc < 2) {
        const int abs_diff = value + 1;
        if (abs_diff > max_frame_num) malformed("abs_diff_pic_num out of range");
        int no_wrap = idc == 0 ? pred - abs_diff : pred + abs_diff;
        if (no_wrap < 0) no_wrap += max_frame_num;
        if (no_wrap >= max_frame_num) no_wrap -= max_frame_num;
        pred = no_wrap;
        const int pic_num = no_wrap > s.frame_num ? no_wrap - max_frame_num : no_wrap;
        for (Picture* p : shorts)
          if (p->frame_num_wrap == pic_num) target = p;
      } else {
        for (Picture* p : longs)
          if (p->long_term_frame_idx == value) target = p;
      }
      if (!target) malformed("a reference list modification names a missing picture");
      if (idx >= s.num_ref_idx[l]) malformed("too many reference list modifications");
      // shift and insert, dropping the later duplicate
      for (int k = s.num_ref_idx[l]; k > idx; k--) list[(size_t)k] = list[(size_t)k - 1];
      list[(size_t)idx++] = target;
      int n = idx;
      for (int k = idx; k <= s.num_ref_idx[l]; k++)
        if (list[(size_t)k] != target) list[(size_t)n++] = list[(size_t)k];
    }
    for (int i = 0; i < 32; i++) s.ref_list[l][i] = i < s.num_ref_idx[l] ? list[(size_t)i] : nullptr;
    for (int i = 0; i < s.num_ref_idx[l]; i++)
      if (!s.ref_list[l][i]) malformed("a reference list has fewer pictures than it names");
  }
}

void Decoder::implicit_weights(Slice& s) {
  for (int i = 0; i < s.num_ref_idx[0]; i++) {
    for (int j = 0; j < s.num_ref_idx[1]; j++) {
      const Picture* p0 = s.ref_list[0][i];
      const Picture* p1 = s.ref_list[1][j];
      int w0 = 32;
      const int td = clip3(-128, 127, p1->poc - p0->poc);
      if (td != 0 && !p0->long_term && !p1->long_term) {
        const int tb = clip3(-128, 127, cur_->poc - p0->poc);
        const int tx = (16384 + std::abs(td / 2)) / td;
        const int dsf = clip3(-1024, 1023, (tb * tx + 32) >> 6);
        if ((dsf >> 2) >= -64 && (dsf >> 2) <= 128) w0 = 64 - (dsf >> 2);
      }
      s.implicit_w[i][j] = w0;
    }
  }
}

// Decoded reference picture marking (8.2.5) after the current picture.
void Decoder::mark_references(const Slice& s, const Sps& sps) {
  const int max_frame_num = 1 << sps.log2_max_frame_num;
  if (s.nal_ref_idc == 0) return;
  bool current_long = false;
  if (s.idr) {
    for (auto& p : pics_)
      if (p.get() != cur_) p->short_term = p->long_term = false;
    if (s.long_term_reference_flag) {
      current_long = true;
      cur_->long_term_frame_idx = 0;
      max_long_term_idx_ = 0;
    } else {
      max_long_term_idx_ = -1;
    }
  } else if (s.adaptive_marking) {
    for (auto& [op, args] : s.mmco) {
      auto short_by_pic_num = [&](int pic_num) -> Picture* {
        for (auto& p : pics_) {
          if (p.get() == cur_ || !p->short_term) continue;
          const int wrap = p->frame_num > s.frame_num ? p->frame_num - max_frame_num : p->frame_num;
          if (wrap == pic_num) return p.get();
        }
        return nullptr;
      };
      if (op == 1 || op == 3) {
        Picture* p = short_by_pic_num(s.frame_num - (args.first + 1));
        if (!p) continue;  // nothing to mark, as decoders do
        if (op == 1) {
          p->short_term = false;
        } else {
          for (auto& q : pics_)
            if (q->long_term && q->long_term_frame_idx == args.second && q.get() != p) q->long_term = false;
          p->short_term = false;
          p->long_term = true;
          p->long_term_frame_idx = args.second;
        }
      } else if (op == 2) {
        for (auto& q : pics_)
          if (q.get() != cur_ && q->long_term && q->long_term_frame_idx == args.first) q->long_term = false;
      } else if (op == 4) {
        max_long_term_idx_ = args.first - 1;
        for (auto& q : pics_)
          if (q->long_term && q->long_term_frame_idx > max_long_term_idx_) q->long_term = false;
      } else if (op == 5) {
        for (auto& q : pics_)
          if (q.get() != cur_) q->short_term = q->long_term = false;
        max_long_term_idx_ = -1;
        cur_->mmco5 = true;
      } else if (op == 6) {
        for (auto& q : pics_)
          if (q.get() != cur_ && q->long_term && q->long_term_frame_idx == args.second) q->long_term = false;
        current_long = true;
        cur_->long_term_frame_idx = args.second;
      }
    }
  } else {
    // sliding window (8.2.5.3)
    int shorts = 0, longs = 0;
    Picture* oldest = nullptr;
    for (auto& p : pics_) {
      if (p.get() == cur_) continue;
      if (p->short_term) {
        shorts++;
        if (!oldest || p->frame_num_wrap < oldest->frame_num_wrap) oldest = p.get();
      }
      if (p->long_term) longs++;
    }
    if (shorts + longs >= std::max(sps.max_num_ref_frames, 1) && oldest) oldest->short_term = false;
  }
  if (current_long) {
    cur_->long_term = true;
  } else {
    cur_->short_term = true;
  }
}

// ---------------------------------------------------------------------------
// Dequantization and inverse transforms (8.5)

constexpr int kNorm4[6][3] = {{10, 16, 13}, {11, 18, 14}, {13, 20, 16},
                              {14, 23, 18}, {16, 25, 20}, {18, 29, 23}};
constexpr int kNorm8[6][6] = {{20, 18, 32, 19, 25, 24}, {22, 19, 35, 21, 28, 26},
                              {26, 23, 42, 24, 33, 31}, {28, 25, 45, 26, 35, 33},
                              {32, 28, 51, 30, 40, 38}, {36, 32, 58, 34, 46, 43}};

int norm4(int m, int i, int j) {
  if (i % 2 == 0 && j % 2 == 0) return kNorm4[m][0];
  if (i % 2 == 1 && j % 2 == 1) return kNorm4[m][1];
  return kNorm4[m][2];
}

int norm8(int m, int i, int j) {
  if (i % 4 == 0 && j % 4 == 0) return kNorm8[m][0];
  if (i % 2 == 1 && j % 2 == 1) return kNorm8[m][1];
  if (i % 4 == 2 && j % 4 == 2) return kNorm8[m][2];
  if ((i % 4 == 0 && j % 2 == 1) || (i % 2 == 1 && j % 4 == 0)) return kNorm8[m][3];
  if ((i % 4 == 0 && j % 4 == 2) || (i % 4 == 2 && j % 4 == 0)) return kNorm8[m][4];
  return kNorm8[m][5];
}

void Decoder::set_level_scale(const Pps& pps) {
  for (int l = 0; l < 6; l++)
    for (int m = 0; m < 6; m++)
      for (int k = 0; k < 16; k++) {
        const int r = kZigzag4[k];
        level4_[l][m][r] = pps.scaling.l4[l][k] * norm4(m, r / 4, r % 4);
      }
  for (int l = 0; l < 2; l++)
    for (int m = 0; m < 6; m++)
      for (int k = 0; k < 64; k++) {
        const int r = kZigzag8[k];
        level8_[l][m][r] = pps.scaling.l8[l][k] * norm8(m, r / 8, r % 8);
      }
}

inline int dequant4(int c, int ls, int qp) {
  return qp >= 24 ? (c * ls) << (qp / 6 - 4) : (c * ls + (1 << (3 - qp / 6))) >> (4 - qp / 6);
}

inline int dequant8(int c, int ls, int qp) {
  return qp >= 36 ? (c * ls) << (qp / 6 - 6) : (c * ls + (1 << (5 - qp / 6))) >> (6 - qp / 6);
}

// d (raster, row * 4 + column) -> residual added to dst, clipped
void idct4_add(const int* d, uint8_t* dst, int stride) {
  int f[16], h[16];
  for (int i = 0; i < 4; i++) {
    const int* r = d + 4 * i;
    const int e0 = r[0] + r[2], e1 = r[0] - r[2], e2 = (r[1] >> 1) - r[3], e3 = r[1] + (r[3] >> 1);
    f[4 * i] = e0 + e3;
    f[4 * i + 1] = e1 + e2;
    f[4 * i + 2] = e1 - e2;
    f[4 * i + 3] = e0 - e3;
  }
  for (int j = 0; j < 4; j++) {
    const int g0 = f[j] + f[8 + j], g1 = f[j] - f[8 + j];
    const int g2 = (f[4 + j] >> 1) - f[12 + j], g3 = f[4 + j] + (f[12 + j] >> 1);
    h[j] = g0 + g3;
    h[4 + j] = g1 + g2;
    h[8 + j] = g1 - g2;
    h[12 + j] = g0 - g3;
  }
  for (int i = 0; i < 4; i++)
    for (int j = 0; j < 4; j++) dst[i * stride + j] = clip1(dst[i * stride + j] + ((h[4 * i + j] + 32) >> 6));
}

void idct8_1d(const int* in, int step, int* out, int ostep) {
  const int d0 = in[0], d1 = in[step], d2 = in[2 * step], d3 = in[3 * step];
  const int d4 = in[4 * step], d5 = in[5 * step], d6 = in[6 * step], d7 = in[7 * step];
  const int a0 = d0 + d4, a4 = d0 - d4, a2 = (d2 >> 1) - d6, a6 = d2 + (d6 >> 1);
  const int b0 = a0 + a6, b2 = a4 + a2, b4 = a4 - a2, b6 = a0 - a6;
  const int a1 = -d3 + d5 - d7 - (d7 >> 1), a3 = d1 + d7 - d3 - (d3 >> 1);
  const int a5 = -d1 + d7 + d5 + (d5 >> 1), a7 = d3 + d5 + d1 + (d1 >> 1);
  const int b1 = a1 + (a7 >> 2), b7 = a7 - (a1 >> 2), b3 = a3 + (a5 >> 2), b5 = (a3 >> 2) - a5;
  out[0] = b0 + b7;
  out[ostep] = b2 + b5;
  out[2 * ostep] = b4 + b3;
  out[3 * ostep] = b6 + b1;
  out[4 * ostep] = b6 - b1;
  out[5 * ostep] = b4 - b3;
  out[6 * ostep] = b2 - b5;
  out[7 * ostep] = b0 - b7;
}

void idct8_add(const int* d, uint8_t* dst, int stride) {
  int f[64], h[64];
  for (int i = 0; i < 8; i++) idct8_1d(d + 8 * i, 1, f + 8 * i, 1);
  for (int j = 0; j < 8; j++) idct8_1d(f + j, 8, h + j, 8);
  for (int i = 0; i < 8; i++)
    for (int j = 0; j < 8; j++) dst[i * stride + j] = clip1(dst[i * stride + j] + ((h[8 * i + j] + 32) >> 6));
}

// ---------------------------------------------------------------------------
// Intra prediction (8.3)

// raster 4x4 block -> luma4x4BlkIdx
constexpr uint8_t kRasterToBlk[16] = {0, 1, 4, 5, 2, 3, 6, 7, 8, 9, 12, 13, 10, 11, 14, 15};

// intra NxN prediction of an N x N block from its neighbours: top[-1..2N-1]
// (top[-1] is the corner), left[0..N-1]
struct Edge {
  int top[17];  // index 0 is p[-1,-1]
  int left[16];
  bool has_top, has_left, has_corner;
  int t(int x) const { return top[x + 1]; }  // x in -1..2N-1
  int l(int y) const { return y < 0 ? top[0] : left[y]; }
};

void predict_nxn(const Edge& e, int n, int mode, uint8_t* dst, int stride) {
  auto put = [&](int x, int y, int v) { dst[y * stride + x] = (uint8_t)v; };
  switch (mode) {
    case 0:  // vertical
      for (int y = 0; y < n; y++)
        for (int x = 0; x < n; x++) put(x, y, e.t(x));
      break;
    case 1:  // horizontal
      for (int y = 0; y < n; y++)
        for (int x = 0; x < n; x++) put(x, y, e.l(y));
      break;
    case 2: {  // DC
      int sum = 0, v;
      const int sh = n == 4 ? 2 : 3;
      if (e.has_top && e.has_left) {
        for (int i = 0; i < n; i++) sum += e.t(i) + e.l(i);
        v = (sum + n) >> (sh + 1);
      } else if (e.has_left) {
        for (int i = 0; i < n; i++) sum += e.l(i);
        v = (sum + n / 2) >> sh;
      } else if (e.has_top) {
        for (int i = 0; i < n; i++) sum += e.t(i);
        v = (sum + n / 2) >> sh;
      } else {
        v = 128;
      }
      for (int y = 0; y < n; y++)
        for (int x = 0; x < n; x++) put(x, y, v);
      break;
    }
    case 3:  // diagonal down left
      for (int y = 0; y < n; y++)
        for (int x = 0; x < n; x++) {
          if (x == n - 1 && y == n - 1)
            put(x, y, (e.t(2 * n - 2) + 3 * e.t(2 * n - 1) + 2) >> 2);
          else
            put(x, y, (e.t(x + y) + 2 * e.t(x + y + 1) + e.t(x + y + 2) + 2) >> 2);
        }
      break;
    case 4:  // diagonal down right
      for (int y = 0; y < n; y++)
        for (int x = 0; x < n; x++) {
          if (x > y)
            put(x, y, (e.t(x - y - 2) + 2 * e.t(x - y - 1) + e.t(x - y) + 2) >> 2);
          else if (x < y)
            put(x, y, (e.l(y - x - 2) + 2 * e.l(y - x - 1) + e.l(y - x) + 2) >> 2);
          else
            put(x, y, (e.t(0) + 2 * e.t(-1) + e.l(0) + 2) >> 2);
        }
      break;
    case 5:  // vertical right
      for (int y = 0; y < n; y++)
        for (int x = 0; x < n; x++) {
          const int z = 2 * x - y;
          if (z >= 0 && !(z & 1))
            put(x, y, (e.t(x - (y >> 1) - 1) + e.t(x - (y >> 1)) + 1) >> 1);
          else if (z >= 0)
            put(x, y, (e.t(x - (y >> 1) - 2) + 2 * e.t(x - (y >> 1) - 1) + e.t(x - (y >> 1)) + 2) >> 2);
          else if (z == -1)
            put(x, y, (e.l(0) + 2 * e.t(-1) + e.t(0) + 2) >> 2);
          else
            put(x, y, (e.l(y - 2 * x - 1) + 2 * e.l(y - 2 * x - 2) + e.l(y - 2 * x - 3) + 2) >> 2);
        }
      break;
    case 6:  // horizontal down
      for (int y = 0; y < n; y++)
        for (int x = 0; x < n; x++) {
          const int z = 2 * y - x;
          if (z >= 0 && !(z & 1))
            put(x, y, (e.l(y - (x >> 1) - 1) + e.l(y - (x >> 1)) + 1) >> 1);
          else if (z >= 0)
            put(x, y, (e.l(y - (x >> 1) - 2) + 2 * e.l(y - (x >> 1) - 1) + e.l(y - (x >> 1)) + 2) >> 2);
          else if (z == -1)
            put(x, y, (e.l(0) + 2 * e.t(-1) + e.t(0) + 2) >> 2);
          else
            put(x, y, (e.t(x - 2 * y - 1) + 2 * e.t(x - 2 * y - 2) + e.t(x - 2 * y - 3) + 2) >> 2);
        }
      break;
    case 7:  // vertical left
      for (int y = 0; y < n; y++)
        for (int x = 0; x < n; x++) {
          if (!(y & 1))
            put(x, y, (e.t(x + (y >> 1)) + e.t(x + (y >> 1) + 1) + 1) >> 1);
          else
            put(x, y, (e.t(x + (y >> 1)) + 2 * e.t(x + (y >> 1) + 1) + e.t(x + (y >> 1) + 2) + 2) >> 2);
        }
      break;
    case 8:  // horizontal up
      for (int y = 0; y < n; y++)
        for (int x = 0; x < n; x++) {
          const int z = x + 2 * y;
          if (z < 2 * n - 3 && !(z & 1))
            put(x, y, (e.l(y + (x >> 1)) + e.l(y + (x >> 1) + 1) + 1) >> 1);
          else if (z < 2 * n - 3)
            put(x, y, (e.l(y + (x >> 1)) + 2 * e.l(y + (x >> 1) + 1) + e.l(y + (x >> 1) + 2) + 2) >> 2);
          else if (z == 2 * n - 3)
            put(x, y, (e.l(n - 2) + 3 * e.l(n - 1) + 2) >> 2);
          else
            put(x, y, e.l(n - 1));
        }
      break;
    default:
      malformed("an intra prediction mode > 8");
  }
}

// The 16x16 luma and 8x8 chroma predictions of Intra_16x16 and of intra
// chroma (8.3.3, 8.3.4), from the samples of plane `p` around (x0, y0).
void predict_plane_block(const uint8_t* p, int stride, int x0, int y0, int n, int mode_v,
                         int mode_h, int mode_dc, int mode_plane, int mode, bool has_top,
                         bool has_left, bool has_corner, bool chroma) {
  uint8_t* dst = const_cast<uint8_t*>(p) + (size_t)y0 * stride + x0;
  auto top = [&](int x) { return (int)p[(size_t)(y0 - 1) * stride + x0 + x]; };
  auto left = [&](int y) { return (int)p[(size_t)(y0 + y) * stride + x0 - 1]; };
  if (mode == mode_v) {
    if (!has_top) malformed("vertical intra prediction without the samples above");
    for (int y = 0; y < n; y++)
      for (int x = 0; x < n; x++) dst[y * stride + x] = (uint8_t)top(x);
  } else if (mode == mode_h) {
    if (!has_left) malformed("horizontal intra prediction without the samples to the left");
    for (int y = 0; y < n; y++)
      for (int x = 0; x < n; x++) dst[y * stride + x] = (uint8_t)left(y);
  } else if (mode == mode_dc) {
    if (!chroma) {
      int sum = 0, v;
      if (has_top && has_left) {
        for (int i = 0; i < 16; i++) sum += top(i) + left(i);
        v = (sum + 16) >> 5;
      } else if (has_left) {
        for (int i = 0; i < 16; i++) sum += left(i);
        v = (sum + 8) >> 4;
      } else if (has_top) {
        for (int i = 0; i < 16; i++) sum += top(i);
        v = (sum + 8) >> 4;
      } else {
        v = 128;
      }
      for (int y = 0; y < 16; y++)
        for (int x = 0; x < 16; x++) dst[y * stride + x] = (uint8_t)v;
    } else {
      for (int by = 0; by < 2; by++)
        for (int bx = 0; bx < 2; bx++) {
          int st = 0, sl = 0, v;
          for (int i = 0; i < 4; i++) {
            if (has_top) st += top(4 * bx + i);
            if (has_left) sl += left(4 * by + i);
          }
          const bool both = (bx == by);
          if (both) {
            if (has_top && has_left) v = (st + sl + 4) >> 3;
            else if (has_left) v = (sl + 2) >> 2;
            else if (has_top) v = (st + 2) >> 2;
            else v = 128;
          } else if (bx == 1) {  // (4, 0): the samples above first
            if (has_top) v = (st + 2) >> 2;
            else if (has_left) v = (sl + 2) >> 2;
            else v = 128;
          } else {  // (0, 4): the samples to the left first
            if (has_left) v = (sl + 2) >> 2;
            else if (has_top) v = (st + 2) >> 2;
            else v = 128;
          }
          for (int y = 0; y < 4; y++)
            for (int x = 0; x < 4; x++) dst[(4 * by + y) * stride + 4 * bx + x] = (uint8_t)v;
        }
    }
  } else if (mode == mode_plane) {
    if (!has_top || !has_left || !has_corner) malformed("plane intra prediction without its neighbours");
    const int half = n / 2;
    int hh = 0, vv = 0;
    for (int i = 0; i < half; i++) {
      hh += (i + 1) * (top(half + i) - top(half - 2 - i));
      vv += (i + 1) * (left(half + i) - left(half - 2 - i));
    }
    const int a = 16 * (left(n - 1) + top(n - 1));
    const int b = chroma ? (34 * hh + 32) >> 6 : (5 * hh + 32) >> 6;
    const int c = chroma ? (34 * vv + 32) >> 6 : (5 * vv + 32) >> 6;
    for (int y = 0; y < n; y++)
      for (int x = 0; x < n; x++)
        dst[y * stride + x] = clip1((a + b * (x - (half - 1)) + c * (y - (half - 1)) + 16) >> 5);
  } else {
    malformed("an intra prediction mode out of range");
  }
}

// ---------------------------------------------------------------------------
// Macroblocks

// Whether the macroblock (mbx_ + dx, mby_ + dy) may serve intra prediction.
bool intra_avail(const MbInfo* m, bool constrained) { return m && (!constrained || m->intra); }

void Decoder::intra_modes_nxn(bool t8x8, int* modes) {
  const bool ci = pps_cur_->constrained_intra_pred;
  const int n = t8x8 ? 4 : 16;
  for (int k = 0; k < n; k++) {
    const int raster = t8x8 ? (k >> 1) * 8 + (k & 1) * 2 : kBlkToRaster[k];
    const int x4 = raster & 3, y4 = raster >> 2;
    int blk_a, blk_b;
    const MbInfo* a = nb4(x4 - 1, y4, blk_a);
    const MbInfo* b = nb4(x4, y4 - 1, blk_b);
    int pred;
    if (!a || !b || (a != mb_ && !a->intra && ci) || (b != mb_ && !b->intra && ci)) {
      pred = 2;
    } else {
      pred = std::min((int)a->intra_modes[blk_a], (int)b->intra_modes[blk_b]);
    }
    const int rem = read_intra_mode();
    const int mode = rem < 0 ? pred : (rem < pred ? rem : rem + 1);
    modes[k] = mode;
    if (t8x8) {
      for (int dy = 0; dy < 2; dy++)
        for (int dx = 0; dx < 2; dx++) mb_->intra_modes[raster + dy * 4 + dx] = (int8_t)mode;
    } else {
      mb_->intra_modes[raster] = (int8_t)mode;
    }
  }
}

// Residual of the luma: coefficient levels into coef4_/coef8_ (dequantized
// later); nnz and the DC flag into mb_.
void Decoder::residual_luma(bool i16, int* dc_levels) {
  int levels[64];
  if (i16) {
    const int n = residual_block(0, cbf_ctx_dc(0, 0), 16, dc_levels);
    if (n) mb_->dc_cbf |= 1;
  }
  std::memset(has_coef4_, 0, sizeof(has_coef4_));
  for (int b8 = 0; b8 < 4; b8++) {
    const bool coded = (mb_->cbp >> b8) & 1;
    if (mb_->t8x8) {
      const int raster = (b8 >> 1) * 8 + (b8 & 1) * 2;
      int n = 0;
      if (coded) {
        n = residual_block(5, -1, 64, levels);
        for (int k = 0; k < 64; k++) coef8_[b8][k] = (int16_t)levels[k];
      }
      for (int dy = 0; dy < 2; dy++)
        for (int dx = 0; dx < 2; dx++) mb_->nnz[raster + dy * 4 + dx] = (uint8_t)n;
      continue;
    }
    for (int k = 0; k < 4; k++) {
      const int raster = kBlkToRaster[b8 * 4 + k];
      const int x4 = raster & 3, y4 = raster >> 2;
      int n = 0;
      if (coded) {
        if (i16) {
          n = residual_block(1, cbf_ctx_luma(1, x4, y4), 15, levels);
          coef4_[raster][0] = 0;
          for (int s = 0; s < 15; s++) coef4_[raster][s + 1] = (int16_t)levels[s];
        } else {
          n = residual_block(2, cbf_ctx_luma(2, x4, y4), 16, levels);
          for (int s = 0; s < 16; s++) coef4_[raster][s] = (int16_t)levels[s];
        }
        has_coef4_[raster] = n > 0;
      }
      mb_->nnz[raster] = (uint8_t)n;
    }
  }
}

void Decoder::chroma_residual() {
  int levels[16];
  std::memset(chroma_dc_, 0, sizeof(chroma_dc_));
  std::memset(has_chroma_ac_, 0, sizeof(has_chroma_ac_));
  const int c = mb_->cbp >> 4;
  if (c == 0) return;
  for (int comp = 0; comp < 2; comp++) {
    const int n = residual_block(3, cbf_ctx_dc(3, comp), 4, levels);
    if (n) mb_->dc_cbf |= 2 << comp;
    for (int k = 0; k < 4; k++) chroma_dc_[comp][k] = (int16_t)levels[k];
  }
  if (c != 2) return;
  for (int comp = 0; comp < 2; comp++)
    for (int b = 0; b < 4; b++) {
      const int n = residual_block(4, cbf_ctx_chroma_ac(comp, b & 1, b >> 1), 15, levels);
      mb_->nnz_c[comp][b] = (uint8_t)n;
      has_chroma_ac_[comp][b] = n > 0;
      chroma_ac_[comp][b][0] = 0;
      for (int s = 0; s < 15; s++) chroma_ac_[comp][b][s + 1] = (int16_t)levels[s];
    }
}

// The 4x4 residual of coefficient levels in scan order (DC given apart
// where dc_given), added to dst.
void add_residual4(const int16_t* scan_levels, bool dc_given, int dc, const int (*ls)[16], int qp,
                   uint8_t* dst, int stride) {
  int d[16];
  for (int k = 0; k < 16; k++) {
    const int r = kZigzag4[k];
    d[r] = (dc_given && k == 0) ? 0 : dequant4(scan_levels[k], ls[qp % 6][r], qp);
  }
  if (dc_given) d[0] = dc;
  idct4_add(d, dst, stride);
}

void Decoder::decode_pcm() {
  bits_.pos = (bits_.pos + 7) & ~int64_t(7);
  uint8_t* y = cur_->y.data() + (size_t)mby_ * 16 * cur_->stride() + mbx_ * 16;
  for (int r = 0; r < 16; r++)
    for (int c = 0; c < 16; c++) y[r * cur_->stride() + c] = (uint8_t)bits_.u(8);
  for (int comp = 0; comp < 2; comp++) {
    uint8_t* p = (comp ? cur_->cr : cur_->cb).data() + (size_t)mby_ * 8 * cur_->cstride() + mbx_ * 8;
    for (int r = 0; r < 8; r++)
      for (int c = 0; c < 8; c++) p[r * cur_->cstride() + c] = (uint8_t)bits_.u(8);
  }
  engine_init();
  mb_->pcm = true;
  mb_->intra = true;
  mb_->qp = 0;
  mb_->cbp = 0x2F;
  std::memset(mb_->nnz, 16, sizeof(mb_->nnz));
  std::memset(mb_->nnz_c, 16, sizeof(mb_->nnz_c));
  mb_->dc_cbf = 7;
  prev_mb_qp_ctx_ = false;
}

// The edge samples of an intra NxN block at luma (px, py) in the picture,
// with the availability rules of 8.3.1.2 and 8.3.2.2.
Edge luma_edge(const Picture& pic, int px, int py, int n, bool top, bool left, bool corner,
               bool top_right) {
  Edge e{};
  const int stride = pic.stride();
  const uint8_t* y = pic.y.data();
  e.has_top = top;
  e.has_left = left;
  e.has_corner = corner;
  if (top) {
    for (int i = 0; i < n; i++) e.top[1 + i] = y[(size_t)(py - 1) * stride + px + i];
    for (int i = n; i < 2 * n; i++)
      e.top[1 + i] = top_right ? y[(size_t)(py - 1) * stride + px + i] : e.top[n];
  }
  if (left)
    for (int i = 0; i < n; i++) e.left[i] = y[(size_t)(py + i) * stride + px - 1];
  if (corner) e.top[0] = y[(size_t)(py - 1) * stride + px - 1];
  return e;
}

// reference sample filtering of Intra_8x8 (8.3.2.2.1)
Edge filter_edge8(const Edge& in) {
  Edge e = in;
  if (in.has_top) {
    e.top[1] = in.has_corner ? (in.top[0] + 2 * in.top[1] + in.top[2] + 2) >> 2
                             : (3 * in.top[1] + in.top[2] + 2) >> 2;
    for (int x = 1; x < 15; x++) e.top[1 + x] = (in.top[x] + 2 * in.top[1 + x] + in.top[2 + x] + 2) >> 2;
    e.top[16] = (in.top[15] + 3 * in.top[16] + 2) >> 2;
  }
  if (in.has_corner) {
    if (in.has_top && in.has_left)
      e.top[0] = (in.top[1] + 2 * in.top[0] + in.left[0] + 2) >> 2;
    else if (in.has_top)
      e.top[0] = (3 * in.top[0] + in.top[1] + 2) >> 2;
    else if (in.has_left)
      e.top[0] = (3 * in.top[0] + in.left[0] + 2) >> 2;
  }
  if (in.has_left) {
    e.left[0] = in.has_corner ? (in.top[0] + 2 * in.left[0] + in.left[1] + 2) >> 2
                              : (3 * in.left[0] + in.left[1] + 2) >> 2;
    for (int y = 1; y < 7; y++) e.left[y] = (in.left[y - 1] + 2 * in.left[y] + in.left[y + 1] + 2) >> 2;
    e.left[7] = (in.left[6] + 3 * in.left[7] + 2) >> 2;
  }
  return e;
}

void Decoder::reconstruct_intra_nxn(const int* modes) {
  const bool ci = pps_cur_->constrained_intra_pred;
  const MbInfo* a = mb_avail(mbx_ - 1, mby_);
  const MbInfo* b = mb_avail(mbx_, mby_ - 1);
  const MbInfo* c = mb_avail(mbx_ + 1, mby_ - 1);
  const MbInfo* d = mb_avail(mbx_ - 1, mby_ - 1);
  const bool av_a = intra_avail(a, ci), av_b = intra_avail(b, ci);
  const bool av_c = intra_avail(c, ci), av_d = intra_avail(d, ci);
  const int stride = cur_->stride();
  const int qp = mb_->qp;
  if (mb_->t8x8) {
    for (int b8 = 0; b8 < 4; b8++) {
      const int x8 = b8 & 1, y8 = b8 >> 1;
      const int px = mbx_ * 16 + 8 * x8, py = mby_ * 16 + 8 * y8;
      const bool top = y8 ? true : av_b;
      const bool left = x8 ? true : av_a;
      const bool corner = (x8 && y8) ? true : (x8 ? av_b : (y8 ? av_a : av_d));
      const bool top_right = b8 == 0 ? av_b : (b8 == 1 ? av_c : (b8 == 2));
      const Edge e = filter_edge8(luma_edge(*cur_, px, py, 8, top, left, corner, top_right));
      uint8_t* dst = cur_->y.data() + (size_t)py * stride + px;
      predict_nxn(e, 8, modes[b8], dst, stride);
      if ((mb_->cbp >> b8) & 1) {
        int d8[64];
        for (int k = 0; k < 64; k++) {
          const int r = kZigzag8[k];
          d8[r] = dequant8(coef8_[b8][k], level8_[0][qp % 6][r], qp);
        }
        idct8_add(d8, dst, stride);
      }
    }
    return;
  }
  for (int k = 0; k < 16; k++) {
    const int raster = kBlkToRaster[k];
    const int x4 = raster & 3, y4 = raster >> 2;
    const int px = mbx_ * 16 + 4 * x4, py = mby_ * 16 + 4 * y4;
    const bool top = y4 ? true : av_b;
    const bool left = x4 ? true : av_a;
    const bool corner = (x4 && y4) ? true : (x4 ? av_b : (y4 ? av_a : av_d));
    bool top_right;
    if (y4 == 0)
      top_right = x4 < 3 ? av_b : av_c;
    else if (x4 == 3)
      top_right = false;
    else
      top_right = kRasterToBlk[(y4 - 1) * 4 + x4 + 1] < k;
    const Edge e = luma_edge(*cur_, px, py, 4, top, left, corner, top_right);
    uint8_t* dst = cur_->y.data() + (size_t)py * stride + px;
    predict_nxn(e, 4, modes[k], dst, stride);
    if (has_coef4_[raster]) add_residual4(coef4_[raster], false, 0, level4_[0], qp, dst, stride);
  }
}

void Decoder::predict_intra16x16(int mode) {
  const bool ci = pps_cur_->constrained_intra_pred;
  const bool a = intra_avail(mb_avail(mbx_ - 1, mby_), ci);
  const bool b = intra_avail(mb_avail(mbx_, mby_ - 1), ci);
  const bool d = intra_avail(mb_avail(mbx_ - 1, mby_ - 1), ci);
  predict_plane_block(cur_->y.data(), cur_->stride(), mbx_ * 16, mby_ * 16, 16, 0, 1, 2, 3, mode, b, a,
                      d, false);
}

void Decoder::predict_chroma(int mode) {
  const bool ci = pps_cur_->constrained_intra_pred;
  const bool a = intra_avail(mb_avail(mbx_ - 1, mby_), ci);
  const bool b = intra_avail(mb_avail(mbx_, mby_ - 1), ci);
  const bool d = intra_avail(mb_avail(mbx_ - 1, mby_ - 1), ci);
  for (int comp = 0; comp < 2; comp++)
    predict_plane_block((comp ? cur_->cr : cur_->cb).data(), cur_->cstride(), mbx_ * 8, mby_ * 8, 8, 2, 1, 0,
                        3, mode, b, a, d, true);
}

void Decoder::decode_mb(bool skip) {
  MbInfo& m = *mb_;
  m.reset();
  m.slice = slice_idx_;
  const int w4 = cur_->width_mbs * 4;
  const int bx0 = mbx_ * 4, by0 = mby_ * 4;
  for (int l = 0; l < 2; l++)
    for (int y = 0; y < 4; y++)
      for (int x = 0; x < 4; x++) {
        const size_t i = (size_t)(by0 + y) * w4 + bx0 + x;
        cur_->ref_idx[l][i] = -1;
        cur_->ref_id[l][i] = -1;
        cur_->mv[l][2 * i] = cur_->mv[l][2 * i + 1] = 0;
      }
  cur_->mb_intra[mb_addr_] = 0;
  std::memset(part_order_, 0, sizeof(part_order_));
  std::memset(has_coef4_, 0, sizeof(has_coef4_));
  if (skip) {
    m.skip = true;
    m.qp = qp_;
    prev_mb_qp_ctx_ = false;
    if (sl_->type == kP) {
      p_skip_motion();
    } else {
      m.direct16 = true;
      std::memset(m.direct8, 1, 4);
      direct_motion(0xF);
    }
    motion_compensate();
    return;
  }
  int t = read_mb_type();
  int itype = -1;  // the I macroblock type, where intra
  if (sl_->type == kI) itype = t;
  else if (sl_->type == kP && t >= 5) itype = t - 5;
  else if (sl_->type == kB && t >= 23) itype = t - 23;
  if (itype == 25) {
    cur_->mb_intra[mb_addr_] = 1;
    decode_pcm();
    return;
  }
  int modes[16];
  int i16_mode = 0;
  bool sub8x8_small = false;  // a sub-macroblock partition below 8x8
  if (itype >= 0) {
    m.intra = true;
    cur_->mb_intra[mb_addr_] = 1;
    if (itype == 0) {
      m.inxn = true;
      if (pps_cur_->transform_8x8_mode) m.t8x8 = read_transform_8x8();
      intra_modes_nxn(m.t8x8, modes);
    } else {
      m.i16 = true;
      i16_mode = (itype - 1) % 4;
      m.cbp = (uint8_t)((((itype - 1) / 4) % 3) << 4 | (itype >= 13 ? 15 : 0));
    }
    m.chroma_pred = (uint8_t)read_chroma_pred();
  } else {
    // inter: partitions, reference indices, motion vector differences
    const bool is_b = sl_->type == kB;
    if (is_b && t == 0) {  // B_Direct_16x16
      m.direct16 = true;
      std::memset(m.direct8, 1, 4);
      direct_motion(0xF);
    } else if ((!is_b && t == 3) || (is_b && t == 22)) {  // 8x8
      int sub[4];
      for (int k = 0; k < 4; k++) sub[k] = read_sub_mb_type();
      int direct_mask = 0;
      for (int k = 0; k < 4; k++) {
        const int shape = is_b ? kBSubShape[sub[k]] : sub[k];
        if (is_b && sub[k] == 0) {
          direct_mask |= 1 << k;
          m.direct8[k] = 1;
          if (!sps_cur_->direct_8x8_inference) sub8x8_small = true;
        }
        if (shape != 0) sub8x8_small = true;
        const int x8 = (k & 1) * 2, y8 = (k >> 1) * 2;
        for (int dy = 0; dy < 2; dy++)
          for (int dx = 0; dx < 2; dx++) {
            int s = 0;
            if (shape == 1) s = dy;
            else if (shape == 2) s = dx;
            else if (shape == 3) s = dy * 2 + dx;
            part_order_[(y8 + dy) * 4 + x8 + dx] = (uint8_t)(k * 4 + s);
          }
      }
      if (direct_mask) direct_motion(direct_mask);
      int refs[2][4];
      for (int l = 0; l < 2; l++)
        for (int k = 0; k < 4; k++) {
          const int pred = is_b ? kBSubPred[sub[k]] : 1;
          refs[l][k] = -1;
          if (m.direct8[k] || !(pred & (1 << l))) continue;
          refs[l][k] = sl_->num_ref_idx[l] > 1 ? read_ref_idx(l, (k & 1) * 2, (k >> 1) * 2) : 0;
          if (refs[l][k] >= sl_->num_ref_idx[l]) malformed("ref_idx past its list");
          m.ref[l][k] = (int8_t)refs[l][k];
        }
      for (int l = 0; l < 2; l++)
        for (int k = 0; k < 4; k++) {
          if (refs[l][k] < 0) continue;
          const int shape = is_b ? kBSubShape[sub[k]] : sub[k];
          const int pw = (shape == 0 || shape == 1) ? 2 : 1, ph = (shape == 0 || shape == 2) ? 2 : 1;
          const int x8 = (k & 1) * 2, y8 = (k >> 1) * 2;
          for (int sy = 0; sy < 2; sy += ph)
            for (int sx = 0; sx < 2; sx += pw) {
              const int x4 = x8 + sx, y4 = y8 + sy;
              const int dx = read_mvd(l, 0, x4, y4), dy = read_mvd(l, 1, x4, y4);
              int px, py;
              mv_pred(l, refs[l][k], x4, y4, pw, 0, 0, px, py);
              set_motion(l, x4, y4, pw, ph, refs[l][k], px + dx, py + dy);
              for (int yy = 0; yy < ph; yy++)
                for (int xx = 0; xx < pw; xx++)
                  for (int c = 0; c < 2; c++)
                    m.mvd[l][(y4 + yy) * 4 + x4 + xx][c] = (uint8_t)std::min(std::abs(c ? dy : dx), 127);
            }
        }
    } else {
      // 16x16, 16x8, 8x16
      int shape, pred[2];
      if (!is_b) {
        shape = t;  // 0 16x16, 1 16x8, 2 8x16
        pred[0] = pred[1] = 1;
      } else {
        shape = t <= 3 ? 0 : ((t & 1) ? 2 : 1);
        pred[0] = kBPred[t][0];
        pred[1] = kBPred[t][1];
      }
      const int parts = shape == 0 ? 1 : 2;
      const int pw = shape == 2 ? 2 : 4, ph = shape == 1 ? 2 : 4;
      if (shape == 1) for (int i = 8; i < 16; i++) part_order_[i] = 4;
      if (shape == 2) for (int i = 0; i < 16; i++) if ((i & 3) >= 2) part_order_[i] = 4;
      int refs[2][2];
      for (int l = 0; l < 2; l++)
        for (int p = 0; p < parts; p++) {
          refs[l][p] = -1;
          if (!(pred[p] & (1 << l))) continue;
          const int x4 = shape == 2 ? 2 * p : 0, y4 = shape == 1 ? 2 * p : 0;
          refs[l][p] = sl_->num_ref_idx[l] > 1 ? read_ref_idx(l, x4, y4) : 0;
          if (refs[l][p] >= sl_->num_ref_idx[l]) malformed("ref_idx past its list");
          for (int k = 0; k < 4; k++) {
            const int kx = (k & 1) * 2, ky = (k >> 1) * 2;
            if (kx >= x4 && kx < x4 + pw && ky >= y4 && ky < y4 + ph) m.ref[l][k] = (int8_t)refs[l][p];
          }
        }
      for (int l = 0; l < 2; l++)
        for (int p = 0; p < parts; p++) {
          if (refs[l][p] < 0) continue;
          const int x4 = shape == 2 ? 2 * p : 0, y4 = shape == 1 ? 2 * p : 0;
          const int dx = read_mvd(l, 0, x4, y4), dy = read_mvd(l, 1, x4, y4);
          int px, py;
          mv_pred(l, refs[l][p], x4, y4, pw, shape, p, px, py);
          set_motion(l, x4, y4, pw, ph, refs[l][p], px + dx, py + dy);
          for (int yy = 0; yy < ph; yy++)
            for (int xx = 0; xx < pw; xx++)
              for (int c = 0; c < 2; c++)
                m.mvd[l][(y4 + yy) * 4 + x4 + xx][c] = (uint8_t)std::min(std::abs(c ? dy : dx), 127);
        }
    }
  }
  if (!m.i16) {
    read_cbp();
    if ((m.cbp & 15) && pps_cur_->transform_8x8_mode && !m.intra && !sub8x8_small &&
        !(m.direct16 && !sps_cur_->direct_8x8_inference))
      m.t8x8 = read_transform_8x8();
  }
  if (m.cbp != 0 || m.i16) {
    const int delta = read_qp_delta();
    if (delta < -26 || delta > 25) malformed("mb_qp_delta out of range");
    qp_ = (qp_ + delta + 52) % 52;
    prev_mb_qp_ctx_ = delta != 0;
  } else {
    prev_mb_qp_ctx_ = false;
  }
  m.qp = qp_;
  int dc_levels[16] = {0};
  if (m.cbp & 15 || m.i16) residual_luma(m.i16, dc_levels);
  chroma_residual();
  const int qp = qp_;
  const int stride = cur_->stride();
  if (m.inxn) {
    reconstruct_intra_nxn(modes);
  } else if (m.i16) {
    predict_intra16x16(i16_mode);
    // DC: inverse Hadamard, then scaling (8.5.10)
    int c[16], f[16], g[16];
    for (int k = 0; k < 16; k++) c[kZigzag4[k]] = dc_levels[k];
    for (int i = 0; i < 4; i++) {
      const int* r = c + 4 * i;
      g[4 * i] = r[0] + r[1] + r[2] + r[3];
      g[4 * i + 1] = r[0] + r[1] - r[2] - r[3];
      g[4 * i + 2] = r[0] - r[1] - r[2] + r[3];
      g[4 * i + 3] = r[0] - r[1] + r[2] - r[3];
    }
    for (int j = 0; j < 4; j++) {
      f[j] = g[j] + g[4 + j] + g[8 + j] + g[12 + j];
      f[4 + j] = g[j] + g[4 + j] - g[8 + j] - g[12 + j];
      f[8 + j] = g[j] - g[4 + j] - g[8 + j] + g[12 + j];
      f[12 + j] = g[j] - g[4 + j] + g[8 + j] - g[12 + j];
    }
    const int ls = level4_[0][qp % 6][0];
    for (int r = 0; r < 16; r++) {
      const int dc = qp >= 36 ? (f[r] * ls) << (qp / 6 - 6) : (f[r] * ls + (1 << (5 - qp / 6))) >> (6 - qp / 6);
      const int x4 = r & 3, y4 = r >> 2;
      uint8_t* dst = cur_->y.data() + (size_t)(mby_ * 16 + 4 * y4) * stride + mbx_ * 16 + 4 * x4;
      if (m.cbp & 15)
        add_residual4(coef4_[r], true, dc, level4_[0], qp, dst, stride);
      else {
        int d[16] = {0};
        d[0] = dc;
        idct4_add(d, dst, stride);
      }
    }
  } else {
    motion_compensate();
    const int list = 3;  // Inter Y
    for (int r = 0; r < 16; r++) {
      if (m.t8x8) break;
      if (!has_coef4_[r] || !((m.cbp >> ((r >> 3) * 2 + ((r & 3) >> 1))) & 1)) continue;
      uint8_t* dst = cur_->y.data() + (size_t)(mby_ * 16 + 4 * (r >> 2)) * stride + mbx_ * 16 + 4 * (r & 3);
      add_residual4(coef4_[r], false, 0, level4_[list], qp, dst, stride);
    }
    if (m.t8x8) {
      for (int b8 = 0; b8 < 4; b8++) {
        if (!((m.cbp >> b8) & 1)) continue;
        int d8[64];
        for (int k = 0; k < 64; k++) {
          const int r = kZigzag8[k];
          d8[r] = dequant8(coef8_[b8][k], level8_[1][qp % 6][r], qp);
        }
        uint8_t* dst = cur_->y.data() + (size_t)(mby_ * 16 + 8 * (b8 >> 1)) * stride + mbx_ * 16 + 8 * (b8 & 1);
        idct8_add(d8, dst, stride);
      }
    }
  }
  if (m.intra) predict_chroma(m.chroma_pred);
  // chroma residual (8.5.11)
  const int c = m.cbp >> 4;
  if (c != 0) {
    for (int comp = 0; comp < 2; comp++) {
      const int qpi = clip3(0, 51, qp + pps_cur_->chroma_qp_offset[comp]);
      const int qpc = kChromaQp[qpi];
      const int list = (m.intra ? 1 : 4) + comp;
      const int16_t* cd = chroma_dc_[comp];
      const int f[4] = {cd[0] + cd[1] + cd[2] + cd[3], cd[0] - cd[1] + cd[2] - cd[3],
                        cd[0] + cd[1] - cd[2] - cd[3], cd[0] - cd[1] - cd[2] + cd[3]};
      const int ls = level4_[list][qpc % 6][0];
      const int cs = cur_->cstride();
      uint8_t* base = (comp ? cur_->cr : cur_->cb).data() + (size_t)mby_ * 8 * cs + mbx_ * 8;
      for (int b = 0; b < 4; b++) {
        const int dc = ((f[b] * ls) << (qpc / 6)) >> 5;
        uint8_t* dst = base + (size_t)(4 * (b >> 1)) * cs + 4 * (b & 1);
        if (c == 2 && has_chroma_ac_[comp][b]) {
          add_residual4(chroma_ac_[comp][b], true, dc, level4_[list], qpc, dst, cs);
        } else {
          int d[16] = {0};
          d[0] = dc;
          idct4_add(d, dst, cs);
        }
      }
    }
  }
}

// ---------------------------------------------------------------------------
// Motion vectors (8.4.1)

// The neighbouring 4x4 block (x4, y4) of the current macroblock's block
// ordered `order_cur`: ref -2 where not available, -1 where intra or not
// predicted from `list`.
void Decoder::mv_neighbour(int list, int x4, int y4, int& ref, int& mvx, int& mvy, bool in_mb_order,
                           int order_cur) const {
  ref = -2;
  mvx = mvy = 0;
  int mx = mbx_, my = mby_, bx = x4, by = y4;
  if (bx < 0) { mx--; bx += 4; } else if (bx > 3) { mx++; bx -= 4; }
  if (by < 0) { my--; by += 4; }
  const MbInfo* m;
  if (mx == mbx_ && my == mby_) {
    if (in_mb_order && part_order_[by * 4 + bx] >= order_cur) return;
    m = mb_;
  } else {
    if (my == mby_ && mx > mbx_) return;  // the macroblock to the right
    m = mb_avail(mx, my);
    if (!m) return;
  }
  ref = -1;
  if (m->intra) return;
  const size_t i = (size_t)(my * 4 + by) * cur_->width_mbs * 4 + mx * 4 + bx;
  if (cur_->ref_idx[list][i] < 0) return;
  ref = cur_->ref_idx[list][i];
  mvx = cur_->mv[list][2 * i];
  mvy = cur_->mv[list][2 * i + 1];
}

// mvpLX of the partition at (x4, y4), w4 blocks wide (8.4.1.3); shape 1:
// 16x8, 2: 8x16 (directional for partition `part`), 0: median
void Decoder::mv_pred(int list, int ref, int x4, int y4, int w4, int shape, int part, int& px,
                      int& py) {
  const int order = part_order_[y4 * 4 + x4];
  int ra, ax, ay, rb, bx, by, rc, cx, cy;
  mv_neighbour(list, x4 - 1, y4, ra, ax, ay, true, order);
  mv_neighbour(list, x4, y4 - 1, rb, bx, by, true, order);
  mv_neighbour(list, x4 + w4, y4 - 1, rc, cx, cy, true, order);
  if (rc == -2) mv_neighbour(list, x4 - 1, y4 - 1, rc, cx, cy, true, order);
  if (shape == 1) {
    if (part == 0 && rb == ref) { px = bx; py = by; return; }
    if (part == 1 && ra == ref) { px = ax; py = ay; return; }
  } else if (shape == 2) {
    if (part == 0 && ra == ref) { px = ax; py = ay; return; }
    if (part == 1 && rc == ref) { px = cx; py = cy; return; }
  }
  if (rb == -2 && rc == -2 && ra != -2) {
    rb = rc = ra;
    bx = cx = ax;
    by = cy = ay;
  }
  const int matches = (ra == ref) + (rb == ref) + (rc == ref);
  if (matches == 1) {
    if (ra == ref) { px = ax; py = ay; }
    else if (rb == ref) { px = bx; py = by; }
    else { px = cx; py = cy; }
    return;
  }
  px = median3(ax, bx, cx);
  py = median3(ay, by, cy);
}

void Decoder::set_motion(int list, int x4, int y4, int w4, int h4, int ref, int mvx, int mvy) {
  if (mvx < -32768 || mvx > 32767 || mvy < -32768 || mvy > 32767) malformed("a motion vector out of range");
  const int w = cur_->width_mbs * 4;
  const Picture* rp = ref >= 0 ? sl_->ref_list[list][ref] : nullptr;
  for (int y = 0; y < h4; y++)
    for (int x = 0; x < w4; x++) {
      const size_t i = (size_t)(mby_ * 4 + y4 + y) * w + mbx_ * 4 + x4 + x;
      cur_->ref_idx[list][i] = (int8_t)ref;
      cur_->ref_id[list][i] = rp ? rp->id : -1;
      cur_->mv[list][2 * i] = (int16_t)mvx;
      cur_->mv[list][2 * i + 1] = (int16_t)mvy;
    }
}

void Decoder::p_skip_motion() {
  int ra, ax, ay, rb, bx, by;
  mv_neighbour(0, -1, 0, ra, ax, ay, false, 0);
  mv_neighbour(0, 0, -1, rb, bx, by, false, 0);
  int px = 0, py = 0;
  if (!(ra == -2 || rb == -2 || (ra == 0 && ax == 0 && ay == 0) || (rb == 0 && bx == 0 && by == 0)))
    mv_pred(0, 0, 0, 0, 4, 0, 0, px, py);
  set_motion(0, 0, 0, 4, 4, 0, px, py);
  mb_->ref[0][0] = mb_->ref[0][1] = mb_->ref[0][2] = mb_->ref[0][3] = 0;
}

// Direct prediction (8.4.1.2) of the 8x8 partitions in part8_mask.
void Decoder::direct_motion(int part8_mask) {
  const Picture* col = sl_->ref_list[1][0];
  if (!col) malformed("direct prediction without RefPicList1[0]");
  const int w = cur_->width_mbs * 4;
  const bool inference = sps_cur_->direct_8x8_inference;
  // the colocated block's motion (8.4.1.2.1)
  auto colocated = [&](int x4, int y4, int& mvx, int& mvy, int& ref, int& ref_id) {
    if (inference) {
      x4 = (x4 >> 1) * 3;
      y4 = (y4 >> 1) * 3;
    }
    const size_t i = (size_t)(mby_ * 4 + y4) * w + mbx_ * 4 + x4;
    if (col->mb_intra[mb_addr_]) {
      mvx = mvy = 0;
      ref = -1;
      ref_id = -1;
      return;
    }
    const int l = col->ref_idx[0][i] >= 0 ? 0 : 1;
    ref = col->ref_idx[l][i];
    ref_id = col->ref_id[l][i];
    mvx = col->mv[l][2 * i];
    mvy = col->mv[l][2 * i + 1];
  };
  if (sl_->direct_spatial) {
    int refs[2], mvp[2][2] = {{0, 0}, {0, 0}};
    for (int l = 0; l < 2; l++) {
      int ra, rb, rc, t0, t1;
      mv_neighbour(l, -1, 0, ra, t0, t1, false, 0);
      mv_neighbour(l, 0, -1, rb, t0, t1, false, 0);
      mv_neighbour(l, 4, -1, rc, t0, t1, false, 0);
      if (rc == -2) mv_neighbour(l, -1, -1, rc, t0, t1, false, 0);
      auto min_positive = [](int x, int y) { return (x >= 0 && y >= 0) ? std::min(x, y) : std::max(x, y); };
      refs[l] = min_positive(ra, min_positive(rb, rc));
      if (refs[l] < -1) refs[l] = -1;
    }
    bool zero = false;
    if (refs[0] < 0 && refs[1] < 0) {
      refs[0] = refs[1] = 0;
      zero = true;
    }
    if (!zero)
      for (int l = 0; l < 2; l++)
        if (refs[l] >= 0) mv_pred(l, refs[l], 0, 0, 4, 0, 0, mvp[l][0], mvp[l][1]);
    for (int k = 0; k < 4; k++) {
      if (!((part8_mask >> k) & 1)) continue;
      for (int l = 0; l < 2; l++) mb_->ref[l][k] = (int8_t)refs[l];
      for (int dy = 0; dy < 2; dy++)
        for (int dx = 0; dx < 2; dx++) {
          const int x4 = (k & 1) * 2 + dx, y4 = (k >> 1) * 2 + dy;
          int cmx, cmy, cref, cid;
          colocated(x4, y4, cmx, cmy, cref, cid);
          const bool col_zero = col->short_term && cref == 0 && cmx >= -1 && cmx <= 1 && cmy >= -1 && cmy <= 1;
          for (int l = 0; l < 2; l++) {
            if (refs[l] < 0) {
              set_motion(l, x4, y4, 1, 1, -1, 0, 0);
              continue;
            }
            const bool zmv = zero || (refs[l] == 0 && col_zero);
            set_motion(l, x4, y4, 1, 1, refs[l], zmv ? 0 : mvp[l][0], zmv ? 0 : mvp[l][1]);
          }
        }
    }
    return;
  }
  // temporal (8.4.1.2.3)
  for (int k = 0; k < 4; k++) {
    if (!((part8_mask >> k) & 1)) continue;
    for (int dy = 0; dy < 2; dy++)
      for (int dx = 0; dx < 2; dx++) {
        const int x4 = (k & 1) * 2 + dx, y4 = (k >> 1) * 2 + dy;
        int cmx, cmy, cref, cid;
        colocated(x4, y4, cmx, cmy, cref, cid);
        int ref0 = 0;
        if (cref >= 0) {
          ref0 = -1;
          for (int i = 0; i < sl_->num_ref_idx[0]; i++)
            if (sl_->ref_list[0][i]->id == cid) { ref0 = i; break; }
          if (ref0 < 0) malformed("temporal direct: the colocated reference is not in RefPicList0");
        }
        const Picture* p0 = sl_->ref_list[0][ref0];
        const Picture* p1 = sl_->ref_list[1][0];
        int m0x, m0y, m1x, m1y;
        const int td = clip3(-128, 127, p1->poc - p0->poc);
        if (p0->long_term || td == 0) {
          m0x = cmx; m0y = cmy; m1x = m1y = 0;
        } else {
          const int tb = clip3(-128, 127, cur_->poc - p0->poc);
          const int tx = (16384 + std::abs(td / 2)) / td;
          const int dsf = clip3(-1024, 1023, (tb * tx + 32) >> 6);
          m0x = (dsf * cmx + 128) >> 8;
          m0y = (dsf * cmy + 128) >> 8;
          m1x = m0x - cmx;
          m1y = m0y - cmy;
        }
        set_motion(0, x4, y4, 1, 1, ref0, m0x, m0y);
        set_motion(1, x4, y4, 1, 1, 0, m1x, m1y);
        if (dx == 0 && dy == 0) {
          mb_->ref[0][k] = (int8_t)ref0;
          mb_->ref[1][k] = 0;
        }
      }
  }
}

// ---------------------------------------------------------------------------
// Inter prediction (8.4.2)

inline int tap6(int a, int b, int c, int d, int e, int f) { return a - 5 * b + 20 * c + 20 * d - 5 * e + f; }

// Luma prediction of a w x h block at (x, y) in `ref` with the quarter-
// sample vector (mvx, mvy) into out (w-wide rows).
void luma_mc(const Picture& ref, int x, int y, int mvx, int mvy, int w, int h, int* out) {
  const int xi = x + (mvx >> 2), yi = y + (mvy >> 2), fx = mvx & 3, fy = mvy & 3;
  const int pw = ref.stride(), ph = ref.height_mbs * 16;
  // the (h + 5) x (w + 5) samples from (xi - 2, yi - 2): the picture itself
  // where they lie inside it, else a copy with the edges replicated
  uint8_t win[21 * 21];
  const uint8_t* src8;
  int st;
  if (xi - 2 >= 0 && yi - 2 >= 0 && xi + w + 3 <= pw && yi + h + 3 <= ph) {
    src8 = ref.y.data() + (size_t)(yi - 2) * pw + xi - 2;
    st = pw;
  } else {
    st = 21;
    for (int r = 0; r < h + 5; r++) {
      const uint8_t* row = ref.y.data() + (size_t)clip3(0, ph - 1, yi - 2 + r) * pw;
      for (int c = 0; c < w + 5; c++) win[r * 21 + c] = row[clip3(0, pw - 1, xi - 2 + c)];
    }
    src8 = win;
  }
  auto S = [&](int r, int c) -> int { return src8[r * st + c]; };
  if (fx == 0 && fy == 0) {
    for (int r = 0; r < h; r++)
      for (int c = 0; c < w; c++) out[r * w + c] = S(r + 2, c + 2);
    return;
  }
  if (fy == 0) {  // a, b, c: the horizontal half sample of the same row
    for (int r = 0; r < h; r++)
      for (int c = 0; c < w; c++) {
        const int bb = clip1((tap6(S(r + 2, c), S(r + 2, c + 1), S(r + 2, c + 2), S(r + 2, c + 3),
                                   S(r + 2, c + 4), S(r + 2, c + 5)) + 16) >> 5);
        out[r * w + c] = fx == 2 ? bb : (S(r + 2, c + 2 + (fx == 3)) + bb + 1) >> 1;
      }
    return;
  }
  if (fx == 0) {  // d, h, n: the vertical half sample of the same column
    for (int r = 0; r < h; r++)
      for (int c = 0; c < w; c++) {
        const int hh = clip1((tap6(S(r, c + 2), S(r + 1, c + 2), S(r + 2, c + 2), S(r + 3, c + 2),
                                   S(r + 4, c + 2), S(r + 5, c + 2)) + 16) >> 5);
        out[r * w + c] = fy == 2 ? hh : (S(r + 2 + (fy == 3), c + 2) + hh + 1) >> 1;
      }
    return;
  }
  // b1 at every window row (the half sample right of G), h1 at every
  // window column (below G), j1 from the b1 column
  int b1[21][16], h1[16][21];
  for (int r = 0; r < h + 5; r++)
    for (int c = 0; c < w; c++)
      b1[r][c] = tap6(S(r, c), S(r, c + 1), S(r, c + 2), S(r, c + 3), S(r, c + 4), S(r, c + 5));
  for (int r = 0; r < h; r++)
    for (int c = 0; c < w + 5; c++)
      h1[r][c] = tap6(S(r, c), S(r + 1, c), S(r + 2, c), S(r + 3, c), S(r + 4, c), S(r + 5, c));
  auto clipb = [](int v) { return (int)clip1((v + 16) >> 5); };
  for (int r = 0; r < h; r++)
    for (int c = 0; c < w; c++) {
      const int bb = clipb(b1[r + 2][c]);          // b
      const int ss = clipb(b1[r + 3][c]);          // s: b of the row below
      const int hh = clipb(h1[r][c + 2]);          // h
      const int mm = clipb(h1[r][c + 3]);          // m: h of the column right
      const int j1 = tap6(b1[r][c], b1[r + 1][c], b1[r + 2][c], b1[r + 3][c], b1[r + 4][c], b1[r + 5][c]);
      const int jj = clip1((j1 + 512) >> 10);
      int v;
      switch (fy * 4 + fx) {
        case 5: v = (bb + hh + 1) >> 1; break;       // e
        case 6: v = (bb + jj + 1) >> 1; break;       // f
        case 7: v = (bb + mm + 1) >> 1; break;       // g
        case 9: v = (hh + jj + 1) >> 1; break;       // i
        case 10: v = jj; break;                      // j
        case 11: v = (jj + mm + 1) >> 1; break;      // k
        case 13: v = (hh + ss + 1) >> 1; break;      // p
        case 14: v = (jj + ss + 1) >> 1; break;      // q
        default: v = (mm + ss + 1) >> 1; break;      // r
      }
      out[r * w + c] = v;
    }
}

// Chroma prediction of a w x h (chroma samples) block at chroma (x, y).
void chroma_mc(const std::vector<uint8_t>& plane, int stride, int height, int x, int y, int mvx, int mvy,
               int w, int h, int* out) {
  const int xi = x + (mvx >> 3), yi = y + (mvy >> 3), fx = mvx & 7, fy = mvy & 7;
  if (xi >= 0 && yi >= 0 && xi + w < stride && yi + h < height) {
    const int wa = (8 - fx) * (8 - fy), wb = fx * (8 - fy), wc = (8 - fx) * fy, wd = fx * fy;
    for (int r = 0; r < h; r++) {
      const uint8_t* s0 = plane.data() + (size_t)(yi + r) * stride + xi;
      const uint8_t* s1 = s0 + stride;
      for (int c = 0; c < w; c++)
        out[r * w + c] = (wa * s0[c] + wb * s0[c + 1] + wc * s1[c] + wd * s1[c + 1] + 32) >> 6;
    }
    return;
  }
  for (int r = 0; r < h; r++) {
    const int y0 = clip3(0, height - 1, yi + r), y1 = clip3(0, height - 1, yi + r + 1);
    for (int c = 0; c < w; c++) {
      const int x0 = clip3(0, stride - 1, xi + c), x1 = clip3(0, stride - 1, xi + c + 1);
      const int a = plane[(size_t)y0 * stride + x0], b = plane[(size_t)y0 * stride + x1];
      const int cc = plane[(size_t)y1 * stride + x0], d = plane[(size_t)y1 * stride + x1];
      out[r * w + c] = ((8 - fx) * (8 - fy) * a + fx * (8 - fy) * b + (8 - fx) * fy * cc + fx * fy * d + 32) >> 6;
    }
  }
}

void Decoder::inter_block(int x4, int y4, int w4, int h4) {
  const int w = cur_->width_mbs * 4;
  const size_t i = (size_t)(mby_ * 4 + y4) * w + mbx_ * 4 + x4;
  const int r0 = cur_->ref_idx[0][i], r1 = cur_->ref_idx[1][i];
  if (r0 < 0 && r1 < 0) malformed("an inter block predicted from no list");
  const int bw = 4 * w4, bh = 4 * h4;
  const int px = mbx_ * 16 + 4 * x4, py = mby_ * 16 + 4 * y4;
  int pred[2][3][256];
  for (int l = 0; l < 2; l++) {
    const int r = l ? r1 : r0;
    if (r < 0) continue;
    const Picture* ref = sl_->ref_list[l][r];
    const int mvx = cur_->mv[l][2 * i], mvy = cur_->mv[l][2 * i + 1];
    luma_mc(*ref, px, py, mvx, mvy, bw, bh, pred[l][0]);
    chroma_mc(ref->cb, ref->cstride(), ref->height_mbs * 8, px / 2, py / 2, mvx, mvy, bw / 2, bh / 2, pred[l][1]);
    chroma_mc(ref->cr, ref->cstride(), ref->height_mbs * 8, px / 2, py / 2, mvx, mvy, bw / 2, bh / 2, pred[l][2]);
  }
  for (int c = 0; c < 3; c++) {
    const int cw = c ? bw / 2 : bw, ch = c ? bh / 2 : bh;
    uint8_t* dst;
    int stride;
    if (c == 0) {
      stride = cur_->stride();
      dst = cur_->y.data() + (size_t)py * stride + px;
    } else {
      stride = cur_->cstride();
      dst = (c == 1 ? cur_->cb : cur_->cr).data() + (size_t)(py / 2) * stride + px / 2;
    }
    const int* p0 = pred[0][c];
    const int* p1 = pred[1][c];
    if (sl_->explicit_wp) {
      const int log_wd = c ? sl_->wp.chroma_log2 : sl_->wp.luma_log2;
      if (r0 >= 0 && r1 >= 0) {
        const int w0 = sl_->wp.w[0][r0][c], w1 = sl_->wp.w[1][r1][c];
        const int o = (sl_->wp.o[0][r0][c] + sl_->wp.o[1][r1][c] + 1) >> 1;
        for (int y = 0; y < ch; y++)
          for (int x = 0; x < cw; x++)
            dst[y * stride + x] = clip1(((p0[y * cw + x] * w0 + p1[y * cw + x] * w1 + (1 << log_wd)) >> (log_wd + 1)) + o);
      } else {
        const int l = r0 >= 0 ? 0 : 1, r = l ? r1 : r0;
        const int* p = l ? p1 : p0;
        const int wt = sl_->wp.w[l][r][c], o = sl_->wp.o[l][r][c];
        for (int y = 0; y < ch; y++)
          for (int x = 0; x < cw; x++) {
            const int v = p[y * cw + x] * wt;
            dst[y * stride + x] = clip1(log_wd >= 1 ? ((v + (1 << (log_wd - 1))) >> log_wd) + o : v + o);
          }
      }
    } else if (r0 >= 0 && r1 >= 0) {
      if (sl_->implicit_wp) {
        const int w0 = sl_->implicit_w[r0][r1], w1 = 64 - w0;
        for (int y = 0; y < ch; y++)
          for (int x = 0; x < cw; x++)
            dst[y * stride + x] = clip1((p0[y * cw + x] * w0 + p1[y * cw + x] * w1 + 32) >> 6);
      } else {
        for (int y = 0; y < ch; y++)
          for (int x = 0; x < cw; x++) dst[y * stride + x] = (uint8_t)((p0[y * cw + x] + p1[y * cw + x] + 1) >> 1);
      }
    } else {
      const int* p = r0 >= 0 ? p0 : p1;
      for (int y = 0; y < ch; y++)
        for (int x = 0; x < cw; x++) dst[y * stride + x] = (uint8_t)p[y * cw + x];
    }
  }
}

// Predict the current macroblock, 8x8 blocks at once where their four 4x4
// blocks share their motion, else 4x4 blocks.
void Decoder::motion_compensate() {
  const int w = cur_->width_mbs * 4;
  auto same = [&](size_t a, size_t b) {
    for (int l = 0; l < 2; l++) {
      if (cur_->ref_idx[l][a] != cur_->ref_idx[l][b]) return false;
      if (cur_->ref_idx[l][a] >= 0 &&
          (cur_->mv[l][2 * a] != cur_->mv[l][2 * b] || cur_->mv[l][2 * a + 1] != cur_->mv[l][2 * b + 1]))
        return false;
    }
    return true;
  };
  const size_t first = (size_t)(mby_ * 4) * w + mbx_ * 4;
  bool uniform = true;
  for (int y = 0; y < 4 && uniform; y++)
    for (int x = 0; x < 4 && uniform; x++) uniform = same(first, first + (size_t)y * w + x);
  mb_->uniform = uniform;
  if (uniform) {
    inter_block(0, 0, 4, 4);
    return;
  }
  for (int k = 0; k < 4; k++) {
    const int x4 = (k & 1) * 2, y4 = (k >> 1) * 2;
    const size_t i = (size_t)(mby_ * 4 + y4) * w + mbx_ * 4 + x4;
    if (same(i, i + 1) && same(i, i + w) && same(i, i + w + 1)) {
      inter_block(x4, y4, 2, 2);
    } else {
      for (int b = 0; b < 4; b++) inter_block(x4 + (b & 1), y4 + (b >> 1), 1, 1);
    }
  }
}

// ---------------------------------------------------------------------------
// Deblocking (8.7)

constexpr uint8_t kAlpha[52] = {0,  0,  0,  0,  0,  0,  0,  0,  0,   0,   0,   0,   0,   0,   0,   0,   4,  4,
                                5,  6,  7,  8,  9,  10, 12, 13, 15,  17,  20,  22,  25,  28,  32,  36,  40, 45,
                                50, 56, 63, 71, 80, 90, 101, 113, 127, 144, 162, 182, 203, 226, 255, 255};
constexpr uint8_t kBeta[52] = {0, 0, 0, 0, 0, 0, 0, 0, 0, 0,  0,  0,  0,  0,  0,  0,  2,  2,
                               2, 3, 3, 3, 3, 4, 4, 4, 6, 6,  7,  7,  8,  8,  9,  9,  10, 10,
                               11, 11, 12, 12, 13, 13, 14, 14, 15, 15, 16, 16, 17, 17, 18, 18};
constexpr uint8_t kTc0[52][3] = {
    {0, 0, 0}, {0, 0, 0}, {0, 0, 0}, {0, 0, 0}, {0, 0, 0}, {0, 0, 0}, {0, 0, 0},   {0, 0, 0},
    {0, 0, 0}, {0, 0, 0}, {0, 0, 0}, {0, 0, 0}, {0, 0, 0}, {0, 0, 0}, {0, 0, 0},   {0, 0, 0},
    {0, 0, 0}, {0, 0, 1}, {0, 0, 1}, {0, 0, 1}, {0, 0, 1}, {0, 1, 1}, {0, 1, 1},   {1, 1, 1},
    {1, 1, 1}, {1, 1, 1}, {1, 1, 1}, {1, 1, 2}, {1, 1, 2}, {1, 1, 2}, {1, 1, 2},   {1, 2, 3},
    {1, 2, 3}, {2, 2, 3}, {2, 2, 4}, {2, 3, 4}, {2, 3, 4}, {3, 3, 5}, {3, 4, 6},   {3, 4, 6},
    {4, 5, 7}, {4, 5, 8}, {4, 6, 9}, {5, 7, 10}, {6, 8, 11}, {6, 8, 13}, {7, 10, 14}, {8, 11, 16},
    {9, 12, 18}, {10, 13, 20}, {11, 15, 23}, {13, 17, 25}};

// one line of samples across an edge: p[k] = p_k (k away from the edge)
void filter_line(uint8_t* q0p, int step, int bs, int alpha, int beta, int index_a, bool chroma) {
  uint8_t* s = q0p;
  const int p0 = s[-step], p1 = s[-2 * step], q0 = s[0], q1 = s[step];
  if (!(std::abs(p0 - q0) < alpha && std::abs(p1 - p0) < beta && std::abs(q1 - q0) < beta)) return;
  if (chroma) {
    if (bs < 4) {
      const int tc = kTc0[index_a][bs - 1] + 1;
      const int delta = clip3(-tc, tc, (((q0 - p0) << 2) + (p1 - q1) + 4) >> 3);
      s[-step] = clip1(p0 + delta);
      s[0] = clip1(q0 - delta);
    } else {
      s[-step] = (uint8_t)((2 * p1 + p0 + q1 + 2) >> 2);
      s[0] = (uint8_t)((2 * q1 + q0 + p1 + 2) >> 2);
    }
    return;
  }
  const int p2 = s[-3 * step], q2 = s[2 * step];
  const int ap = std::abs(p2 - p0), aq = std::abs(q2 - q0);
  if (bs < 4) {
    const int tc0 = kTc0[index_a][bs - 1];
    const int tc = tc0 + (ap < beta) + (aq < beta);
    const int delta = clip3(-tc, tc, (((q0 - p0) << 2) + (p1 - q1) + 4) >> 3);
    s[-step] = clip1(p0 + delta);
    s[0] = clip1(q0 - delta);
    if (ap < beta) s[-2 * step] = (uint8_t)(p1 + clip3(-tc0, tc0, (p2 + ((p0 + q0 + 1) >> 1) - (p1 << 1)) >> 1));
    if (aq < beta) s[step] = (uint8_t)(q1 + clip3(-tc0, tc0, (q2 + ((p0 + q0 + 1) >> 1) - (q1 << 1)) >> 1));
    return;
  }
  const int p3 = s[-4 * step], q3 = s[3 * step];
  const bool strong = std::abs(p0 - q0) < ((alpha >> 2) + 2);
  if (ap < beta && strong) {
    s[-step] = (uint8_t)((p2 + 2 * p1 + 2 * p0 + 2 * q0 + q1 + 4) >> 3);
    s[-2 * step] = (uint8_t)((p2 + p1 + p0 + q0 + 2) >> 2);
    s[-3 * step] = (uint8_t)((2 * p3 + 3 * p2 + p1 + p0 + q0 + 4) >> 3);
  } else {
    s[-step] = (uint8_t)((2 * p1 + p0 + q1 + 2) >> 2);
  }
  if (aq < beta && strong) {
    s[0] = (uint8_t)((p1 + 2 * p0 + 2 * q0 + 2 * q1 + q2 + 4) >> 3);
    s[step] = (uint8_t)((p0 + q0 + q1 + q2 + 2) >> 2);
    s[2 * step] = (uint8_t)((2 * q3 + 3 * q2 + q1 + q0 + p0 + 4) >> 3);
  } else {
    s[0] = (uint8_t)((2 * q1 + q0 + p1 + 2) >> 2);
  }
}

struct Deblocker {
  Picture& pic;
  const std::vector<MbInfo>& mbs;
  const std::vector<Slice>& slices;
  const std::vector<Pps>& pps;

  int w4() const { return pic.width_mbs * 4; }

  // bS of the edge between 4x4 blocks (pxb, pyb) and (qxb, qyb) (picture
  // block coordinates)
  int strength(const MbInfo& p, const MbInfo& q, int pxb, int pyb, int qxb, int qyb, bool mb_edge) const {
    if (p.intra || q.intra) return mb_edge ? 4 : 3;
    const int pb = (pyb & 3) * 4 + (pxb & 3), qb = (qyb & 3) * 4 + (qxb & 3);
    if (p.nnz[pb] || q.nnz[qb]) return 2;
    const size_t pi = (size_t)pyb * w4() + pxb, qi = (size_t)qyb * w4() + qxb;
    int pr[2], qr[2], pm[2][2], qm[2][2], np = 0, nq = 0;
    for (int l = 0; l < 2; l++) {
      if (pic.ref_idx[l][pi] >= 0) {
        pr[np] = pic.ref_id[l][pi];
        pm[np][0] = pic.mv[l][2 * pi];
        pm[np][1] = pic.mv[l][2 * pi + 1];
        np++;
      }
      if (pic.ref_idx[l][qi] >= 0) {
        qr[nq] = pic.ref_id[l][qi];
        qm[nq][0] = pic.mv[l][2 * qi];
        qm[nq][1] = pic.mv[l][2 * qi + 1];
        nq++;
      }
    }
    auto far = [](const int* a, const int* b) { return std::abs(a[0] - b[0]) >= 4 || std::abs(a[1] - b[1]) >= 4; };
    if (np != nq) return 1;
    if (np == 1) return (pr[0] != qr[0] || far(pm[0], qm[0])) ? 1 : 0;
    if (!((pr[0] == qr[0] && pr[1] == qr[1]) || (pr[0] == qr[1] && pr[1] == qr[0]))) return 1;
    if (pr[0] != pr[1]) {
      if (pr[0] == qr[0]) return (far(pm[0], qm[0]) || far(pm[1], qm[1])) ? 1 : 0;
      return (far(pm[0], qm[1]) || far(pm[1], qm[0])) ? 1 : 0;
    }
    return ((far(pm[0], qm[0]) || far(pm[1], qm[1])) && (far(pm[0], qm[1]) || far(pm[1], qm[0]))) ? 1 : 0;
  }

  void run() {
    const int wm = pic.width_mbs, hm = pic.height_mbs;
    for (int my = 0; my < hm; my++)
      for (int mx = 0; mx < wm; mx++) mb(mx, my);
  }

  void mb(int mx, int my) {
    const MbInfo& q = mbs[(size_t)my * pic.width_mbs + mx];
    const Slice& s = slices[(size_t)q.slice];
    if (s.disable_deblocking == 1) return;
    const Pps& pp = pps[(size_t)s.pps_id];
    for (int dir = 0; dir < 2; dir++) {  // 0: vertical edges, 1: horizontal
      for (int e = 0; e < 4; e++) {
        const bool mb_edge = e == 0;
        const MbInfo* p = &q;
        if (mb_edge) {
          if (dir == 0 ? mx == 0 : my == 0) continue;
          p = &mbs[(size_t)(my - dir) * pic.width_mbs + mx - (1 - dir)];
          if (s.disable_deblocking == 2 && p->slice != q.slice) continue;
        } else if ((q.t8x8 && (e & 1)) || (q.uniform && !(q.cbp & 15))) {
          continue;  // no transform edge, or bS 0 on every internal edge
        }
        int bs[4];
        bool any = false;
        for (int k = 0; k < 4; k++) {
          const int qxb = mx * 4 + (dir == 0 ? e : k), qyb = my * 4 + (dir == 0 ? k : e);
          const int pxb = qxb - (dir == 0 ? 1 : 0), pyb = qyb - (dir == 0 ? 0 : 1);
          bs[k] = strength(*p, q, pxb, pyb, qxb, qyb, mb_edge);
          any |= bs[k] != 0;
        }
        if (!any) continue;
        // luma
        {
          const int qpav = (p->qp + q.qp + 1) >> 1;
          const int ia = clip3(0, 51, qpav + s.alpha_offset), ib = clip3(0, 51, qpav + s.beta_offset);
          const int alpha = kAlpha[ia], beta = kBeta[ib];
          const int stride = pic.stride();
          for (int i = 0; i < 16; i++) {
            const int b = bs[i / 4];
            if (!b) continue;
            const int x = mx * 16 + (dir == 0 ? 4 * e : i), y = my * 16 + (dir == 0 ? i : 4 * e);
            filter_line(pic.y.data() + (size_t)y * stride + x, dir == 0 ? 1 : stride, b, alpha, beta, ia, false);
          }
        }
        // chroma: the edges at chroma 0 and 4 (luma 0 and 8)
        if (e & 1) continue;
        for (int comp = 0; comp < 2; comp++) {
          auto qpc = [&](const MbInfo& m) { return kChromaQp[clip3(0, 51, m.qp + pp.chroma_qp_offset[comp])]; };
          const int qpav = (qpc(*p) + qpc(q) + 1) >> 1;
          const int ia = clip3(0, 51, qpav + s.alpha_offset), ib = clip3(0, 51, qpav + s.beta_offset);
          const int alpha = kAlpha[ia], beta = kBeta[ib];
          const int stride = pic.cstride();
          uint8_t* plane = (comp ? pic.cr : pic.cb).data();
          for (int i = 0; i < 8; i++) {
            const int b = bs[i / 2];
            if (!b) continue;
            const int x = mx * 8 + (dir == 0 ? 2 * e : i), y = my * 8 + (dir == 0 ? i : 2 * e);
            filter_line(plane + (size_t)y * stride + x, dir == 0 ? 1 : stride, b, alpha, beta, ia, true);
          }
        }
      }
    }
  }
};

// ---------------------------------------------------------------------------
// Pictures and access units

void Decoder::collect() {
  for (auto& p : pics_)
    if (p && p.get() != cur_ && !p->is_ref() && !p->held) free_.push_back(std::move(p));
  pics_.erase(std::remove(pics_.begin(), pics_.end(), nullptr), pics_.end());
  if (free_.size() > 4) free_.erase(free_.begin(), free_.end() - 4);
}

void Decoder::start_picture(const Slice& s, const Sps& sps) {
  if (!s.idr && !have_prev_) malformed("the stream does not start with an IDR picture");
  const int max_frame_num = 1 << sps.log2_max_frame_num;
  if (!s.idr && s.frame_num != prev_ref_frame_num_ && s.frame_num != (prev_ref_frame_num_ + 1) % max_frame_num)
    unsupported("a gap in frame_num (lost or dropped reference pictures)");
  std::unique_ptr<Picture> pic;
  for (auto& f : free_)
    if (f && f->width_mbs == sps.width_mbs && f->height_mbs == sps.height_mbs) {
      pic = std::move(f);
      break;
    }
  free_.erase(std::remove(free_.begin(), free_.end(), nullptr), free_.end());
  if (!pic) {
    pic = std::make_unique<Picture>();
    allocate(*pic, sps.width_mbs, sps.height_mbs);
  }
  pic->short_term = pic->long_term = pic->mmco5 = pic->held = false;
  pic->id = next_id_++;
  pic->frame_num = s.frame_num;
  pic->crop[0] = sps.crop_left;
  pic->crop[1] = sps.crop_right;
  pic->crop[2] = sps.crop_top;
  pic->crop[3] = sps.crop_bottom;
  pic->full_range = sps.full_range;
  cur_ = pic.get();
  pics_.push_back(std::move(pic));
  sps_cur_ = &sps;
  mbs_.assign((size_t)sps.width_mbs * sps.height_mbs, MbInfo());
  slices_.clear();
  compute_poc(s, sps);
}

void Decoder::finish_picture() {
  for (const MbInfo& m : mbs_)
    if (m.slice < 0) malformed("a picture lacks some of its macroblocks");
  Deblocker{*cur_, mbs_, slices_, pps_}.run();
  const Slice& s = slices_[0];
  const Sps& sps = *sps_cur_;
  mark_references(s, sps);
  if (cur_->mmco5) {
    cur_->poc = 0;
    cur_->frame_num = 0;
    prev_poc_msb_ = prev_poc_lsb_ = 0;
  }
  prev_frame_num_ = cur_->frame_num;
  prev_frame_num_offset_ = cur_->mmco5 ? 0 : frame_num_offset_;
  if (s.nal_ref_idc) prev_ref_frame_num_ = cur_->frame_num;
  have_prev_ = true;
  cur_ = nullptr;
  collect();
}

void Decoder::decode_slice(Bits& b, int index) {
  slice_idx_ = index;
  sl_ = &slices_[(size_t)index];
  pps_cur_ = &pps_[(size_t)sl_->pps_id];
  while (!b.byte_aligned())
    if (b.bit() != 1) malformed("cabac_alignment_one_bit is 0");
  bits_ = b;
  cabac_init();
  engine_init();
  qp_ = sl_->qp;
  prev_mb_qp_ctx_ = false;
  const int total = cur_->width_mbs * cur_->height_mbs;
  for (int addr = sl_->first_mb;; addr++) {
    if (addr >= total) malformed("a slice runs past the last macroblock");
    mb_addr_ = addr;
    mbx_ = addr % cur_->width_mbs;
    mby_ = addr / cur_->width_mbs;
    mb_ = &mbs_[(size_t)addr];
    if (mb_->slice >= 0) malformed("a macroblock is coded twice");
    const bool skip = sl_->type != kI && read_mb_skip();
    decode_mb(skip);
    if (terminate()) break;
  }
}

void Decoder::decode_au(const uint8_t* data, int64_t size, int64_t tag) {
  if (find(tag)) malformed("a picture with this tag is already held");
  bool picture_open = false;
  int64_t i = 0;
  auto next_start = [&](int64_t from) -> int64_t {
    for (int64_t k = from; k + 2 < size; k++)
      if (data[k] == 0 && data[k + 1] == 0 && data[k + 2] == 1) return k;
    return size;
  };
  i = next_start(0);
  while (i < size) {
    const int64_t begin = i + 3;
    int64_t end = next_start(begin);
    const int64_t next = end;
    while (end > begin && data[end - 1] == 0) end--;  // trailing zero bytes / 4-byte start codes
    if (end <= begin) { i = next; continue; }
    // emulation prevention bytes
    nal_.clear();
    nal_.reserve((size_t)(end - begin));
    int zeros = 0;
    for (int64_t k = begin + 1; k < end; k++) {
      const uint8_t v = data[k];
      if (zeros >= 2 && v == 3) {
        zeros = 0;
        continue;
      }
      zeros = v == 0 ? zeros + 1 : 0;
      nal_.push_back(v);
    }
    const int header = data[begin];
    const int nal_ref_idc = (header >> 5) & 3, type = header & 31;
    Bits b{nal_.data(), (int64_t)nal_.size(), 0};
    if (type == 7) {
      parse_sps(b, sps_);
    } else if (type == 8) {
      parse_pps(b, pps_, sps_);
    } else if (type == 1 || type == 5) {
      Slice s;
      parse_slice_header(b, type, nal_ref_idc, s);
      const Pps& pps = pps_[(size_t)s.pps_id];
      const Sps& sps = sps_[(size_t)pps.sps_id];
      if (!picture_open) {
        if (s.first_mb != 0) malformed("a picture's first slice does not start at macroblock 0");
        start_picture(s, sps);
        picture_open = true;
      } else if (s.first_mb == 0) {
        malformed("two pictures in one access unit");
      }
      if (&sps != sps_cur_) malformed("the slices of a picture name different SPSs");
      build_ref_lists(s, sps);
      if (s.implicit_wp) implicit_weights(s);
      slices_.push_back(s);
      set_level_scale(pps);
      decode_slice(b, (int)slices_.size() - 1);
    } else if (type >= 2 && type <= 4) {
      unsupported("data partitioning");
    }
    i = next;
  }
  if (!picture_open) malformed("an access unit without a slice");
  Picture* done = cur_;
  done->tag = tag;
  done->held = true;
  finish_picture();
}

}  // namespace
}  // namespace h264

using h264::Decoder;

namespace {

int report(const h264::Failure& f, char* err, int err_len) {
  if (err && err_len > 0) std::snprintf(err, (size_t)err_len, "%s", f.what.c_str());
  return f.code;
}

}  // namespace

extern "C" {

void* vdqn_h264_open(void) { return new Decoder(); }

int vdqn_h264_decode(void* h, const uint8_t* au, int64_t size, int64_t tag, char* err, int err_len) {
  try {
    static_cast<Decoder*>(h)->decode_au(au, size, tag);
    return 0;
  } catch (const h264::Failure& f) {
    return report(f, err, err_len);
  } catch (const std::bad_alloc&) {
    return report(h264::Failure{2, "out of memory (malformed sizes?)"}, err, err_len);
  }
}

int vdqn_h264_info(void* h, int64_t tag, int32_t* info) {
  const h264::Picture* p = static_cast<Decoder*>(h)->find(tag);
  if (!p) return -1;
  info[0] = p->stride() - p->crop[0] - p->crop[1];
  info[1] = p->height_mbs * 16 - p->crop[2] - p->crop[3];
  info[2] = p->stride();
  info[3] = p->height_mbs * 16;
  info[4] = p->full_range;
  return 0;
}

int vdqn_h264_copy(void* h, int64_t tag, uint8_t* y, int64_t y_pitch, uint8_t* uv, int64_t uv_pitch) {
  const h264::Picture* p = static_cast<Decoder*>(h)->find(tag);
  if (!p) return -1;
  const int w = p->stride() - p->crop[0] - p->crop[1];
  const int ht = p->height_mbs * 16 - p->crop[2] - p->crop[3];
  for (int r = 0; r < ht; r++)
    std::memcpy(y + r * y_pitch, p->y.data() + (size_t)(r + p->crop[2]) * p->stride() + p->crop[0], (size_t)w);
  for (int r = 0; r < ht / 2; r++) {
    const size_t row = (size_t)(r + p->crop[2] / 2) * p->cstride() + p->crop[0] / 2;
    uint8_t* out = uv + r * uv_pitch;
    for (int c = 0; c < w / 2; c++) {
      out[2 * c] = p->cb[row + c];
      out[2 * c + 1] = p->cr[row + c];
    }
  }
  return 0;
}

void vdqn_h264_release(void* h, int64_t tag) { static_cast<Decoder*>(h)->release(tag); }

void vdqn_h264_close(void* h) { delete static_cast<Decoder*>(h); }

}  // extern "C"
