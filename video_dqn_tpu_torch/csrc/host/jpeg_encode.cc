// Batched baseline JPEG encode, written from the JPEG standard (ITU-T T.81)
// and libjpeg's compression defaults, with no codec library.
//
// Counterpart of PIL's Image.save(path) (quality 75 unless asked) over
// libjpeg-turbo, the writer of the JAX package's simulator frames
// (video_dqn_tpu/data/sim_dataset.py). Per image it computes what
// libjpeg's defaults compute, so that the file equals PIL's byte for byte:
//   * baseline, 8-bit, JFIF 1.01 (density 1:1, no units), YCbCr 4:2:0
//     (luma 2x2, chroma 1x1), one interleaved scan, no restart markers;
//   * the Annex K quantisation tables scaled as jpeg_quality_scaling and
//     jpeg_add_quant_table do (force_baseline: clamped to 1..255);
//   * jccolor.c's fixed-point RGB -> YCbCr (16 fraction bits, Cb and Cr
//     rounded with 0.5 - epsilon);
//   * jcsample.c: luma copied, chroma h2v2 as the mean of 2x2 pixels with
//     a bias alternating 1, 2 by output column; the right edge replicated
//     to the downsampler's width, rows padded to an even count before the
//     downsample and to the iMCU height after it by replicating the last
//     row (jcprepct.c);
//   * jfdctint.c's islow forward DCT on samples less 128;
//   * jcdctmgr.c's quantiser: the divisor q << 3 applied as libjpeg-turbo's
//     16-bit reciprocal, multiply and shift, on the magnitude, the sign
//     restored after;
//   * jccoefct.c's dummy blocks where an MCU runs past the luma blocks: AC
//     zero, DC that of the block before;
//   * the Annex K Huffman tables, the bit buffer's last byte padded with
//     ones, 0xFF bytes stuffed with 0x00.
//
// C ABI (ctypes; video_dqn_tpu_torch/data/jpeg.py save_images):
//   int vdqn_jpeg_encode_batch(const char* const* paths, int n,
//                              const uint8_t* images,  // n * height * width * 3 RGB
//                              int height, int width, int quality,
//                              int32_t* status,        // n codes, 0 = written
//                              int n_threads);         // 0 = every hardware thread
//   returns the number of images that failed.

#include <algorithm>
#include <atomic>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <new>
#include <thread>
#include <vector>

namespace {

// status codes, named in data/jpeg.py ENCODE_STATUS
enum Status {
  kOk = 0,
  kOpenError = 1,
  kWriteError = 2,
  kBadArgument = 3,
  kTooLarge = 4,
};

const int kNatural[64] = {0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18,
                          11, 4,  5,  12, 19, 26, 33, 40, 48, 41, 34, 27, 20,
                          13, 6,  7,  14, 21, 28, 35, 42, 49, 56, 57, 50, 43,
                          36, 29, 22, 15, 23, 30, 37, 44, 51, 58, 59, 52, 45,
                          38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63};

// Annex K.1, natural order
const int kLumaQuant[64] = {
    16, 11, 10, 16, 24,  40,  51,  61,  12, 12, 14, 19, 26,  58,  60,  55,
    14, 13, 16, 24, 40,  57,  69,  56,  14, 17, 22, 29, 51,  87,  80,  62,
    18, 22, 37, 56, 68,  109, 103, 77,  24, 35, 55, 64, 81,  104, 113, 92,
    49, 64, 78, 87, 103, 121, 120, 101, 72, 92, 95, 98, 112, 100, 103, 99};
const int kChromaQuant[64] = {
    17, 18, 24, 47, 99, 99, 99, 99, 18, 21, 26, 66, 99, 99, 99, 99,
    24, 26, 56, 99, 99, 99, 99, 99, 47, 66, 99, 99, 99, 99, 99, 99,
    99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99,
    99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99};

// Annex K.3: code counts of lengths 1..16, then the values
const uint8_t kDcLumaBits[16] = {0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0};
const uint8_t kDcChromaBits[16] = {0, 3, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0};
const uint8_t kDcVals[12] = {0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11};
const uint8_t kAcLumaBits[16] = {0, 2, 1, 3, 3, 2, 4, 3, 5, 5, 4, 4, 0, 0, 1, 0x7d};
const uint8_t kAcLumaVals[162] = {
    0x01, 0x02, 0x03, 0x00, 0x04, 0x11, 0x05, 0x12, 0x21, 0x31, 0x41, 0x06, 0x13, 0x51,
    0x61, 0x07, 0x22, 0x71, 0x14, 0x32, 0x81, 0x91, 0xa1, 0x08, 0x23, 0x42, 0xb1, 0xc1,
    0x15, 0x52, 0xd1, 0xf0, 0x24, 0x33, 0x62, 0x72, 0x82, 0x09, 0x0a, 0x16, 0x17, 0x18,
    0x19, 0x1a, 0x25, 0x26, 0x27, 0x28, 0x29, 0x2a, 0x34, 0x35, 0x36, 0x37, 0x38, 0x39,
    0x3a, 0x43, 0x44, 0x45, 0x46, 0x47, 0x48, 0x49, 0x4a, 0x53, 0x54, 0x55, 0x56, 0x57,
    0x58, 0x59, 0x5a, 0x63, 0x64, 0x65, 0x66, 0x67, 0x68, 0x69, 0x6a, 0x73, 0x74, 0x75,
    0x76, 0x77, 0x78, 0x79, 0x7a, 0x83, 0x84, 0x85, 0x86, 0x87, 0x88, 0x89, 0x8a, 0x92,
    0x93, 0x94, 0x95, 0x96, 0x97, 0x98, 0x99, 0x9a, 0xa2, 0xa3, 0xa4, 0xa5, 0xa6, 0xa7,
    0xa8, 0xa9, 0xaa, 0xb2, 0xb3, 0xb4, 0xb5, 0xb6, 0xb7, 0xb8, 0xb9, 0xba, 0xc2, 0xc3,
    0xc4, 0xc5, 0xc6, 0xc7, 0xc8, 0xc9, 0xca, 0xd2, 0xd3, 0xd4, 0xd5, 0xd6, 0xd7, 0xd8,
    0xd9, 0xda, 0xe1, 0xe2, 0xe3, 0xe4, 0xe5, 0xe6, 0xe7, 0xe8, 0xe9, 0xea, 0xf1, 0xf2,
    0xf3, 0xf4, 0xf5, 0xf6, 0xf7, 0xf8, 0xf9, 0xfa};
const uint8_t kAcChromaBits[16] = {0, 2, 1, 2, 4, 4, 3, 4, 7, 5, 4, 4, 0, 1, 2, 0x77};
const uint8_t kAcChromaVals[162] = {
    0x00, 0x01, 0x02, 0x03, 0x11, 0x04, 0x05, 0x21, 0x31, 0x06, 0x12, 0x41, 0x51, 0x07,
    0x61, 0x71, 0x13, 0x22, 0x32, 0x81, 0x08, 0x14, 0x42, 0x91, 0xa1, 0xb1, 0xc1, 0x09,
    0x23, 0x33, 0x52, 0xf0, 0x15, 0x62, 0x72, 0xd1, 0x0a, 0x16, 0x24, 0x34, 0xe1, 0x25,
    0xf1, 0x17, 0x18, 0x19, 0x1a, 0x26, 0x27, 0x28, 0x29, 0x2a, 0x35, 0x36, 0x37, 0x38,
    0x39, 0x3a, 0x43, 0x44, 0x45, 0x46, 0x47, 0x48, 0x49, 0x4a, 0x53, 0x54, 0x55, 0x56,
    0x57, 0x58, 0x59, 0x5a, 0x63, 0x64, 0x65, 0x66, 0x67, 0x68, 0x69, 0x6a, 0x73, 0x74,
    0x75, 0x76, 0x77, 0x78, 0x79, 0x7a, 0x82, 0x83, 0x84, 0x85, 0x86, 0x87, 0x88, 0x89,
    0x8a, 0x92, 0x93, 0x94, 0x95, 0x96, 0x97, 0x98, 0x99, 0x9a, 0xa2, 0xa3, 0xa4, 0xa5,
    0xa6, 0xa7, 0xa8, 0xa9, 0xaa, 0xb2, 0xb3, 0xb4, 0xb5, 0xb6, 0xb7, 0xb8, 0xb9, 0xba,
    0xc2, 0xc3, 0xc4, 0xc5, 0xc6, 0xc7, 0xc8, 0xc9, 0xca, 0xd2, 0xd3, 0xd4, 0xd5, 0xd6,
    0xd7, 0xd8, 0xd9, 0xda, 0xe2, 0xe3, 0xe4, 0xe5, 0xe6, 0xe7, 0xe8, 0xe9, 0xea, 0xf2,
    0xf3, 0xf4, 0xf5, 0xf6, 0xf7, 0xf8, 0xf9, 0xfa};

// a Huffman table as its marker segment gives it, and the codes derived
// from it (jchuff.c jpeg_make_c_derived_tbl)
struct HuffTable {
  const uint8_t* bits;
  const uint8_t* vals;
  int nvals;
  uint16_t code[256];
  uint8_t size[256];

  HuffTable(const uint8_t* b, const uint8_t* v, int n) : bits(b), vals(v), nvals(n) {
    std::memset(code, 0, sizeof(code));
    std::memset(size, 0, sizeof(size));
    int c = 0, k = 0;
    for (int len = 1; len <= 16; len++) {
      for (int j = 0; j < bits[len - 1]; j++, k++, c++) {
        code[vals[k]] = (uint16_t)c;
        size[vals[k]] = (uint8_t)len;
      }
      c <<= 1;
    }
  }
};

const HuffTable kDcLuma(kDcLumaBits, kDcVals, 12);
const HuffTable kDcChroma(kDcChromaBits, kDcVals, 12);
const HuffTable kAcLuma(kAcLumaBits, kAcLumaVals, 162);
const HuffTable kAcChroma(kAcChromaBits, kAcChromaVals, 162);

// jccolor.c's tables: FIX(x) = x * 2^16 rounded
const int kScaleBits = 16;
const int32_t kOneHalf = 1 << (kScaleBits - 1);
const int32_t kCbCrOffset = 128 << kScaleBits;
int32_t fix(double x) { return (int32_t)(x * (1 << kScaleBits) + 0.5); }

struct ColorTables {
  int32_t ry[256], gy[256], by[256], rcb[256], gcb[256], bcb[256], gcr[256], bcr[256];
  ColorTables() {
    for (int i = 0; i < 256; i++) {
      ry[i] = fix(0.29900) * i;
      gy[i] = fix(0.58700) * i;
      by[i] = fix(0.11400) * i + kOneHalf;
      rcb[i] = -fix(0.16874) * i;
      gcb[i] = -fix(0.33126) * i;
      // 0.5 - epsilon, so that no output rounds above 255; R -> Cr is the same table
      bcb[i] = fix(0.50000) * i + kCbCrOffset + kOneHalf - 1;
      gcr[i] = -fix(0.41869) * i;
      bcr[i] = -fix(0.08131) * i;
    }
  }
};
const ColorTables kColor;

// quantisation table of `quality` (jcparam.c), natural order
void quant_table(const int* basic, int quality, uint16_t* out) {
  quality = std::min(100, std::max(1, quality));
  const long scale = quality < 50 ? 5000 / quality : 200 - quality * 2;
  for (int i = 0; i < 64; i++) {
    long v = (basic[i] * scale + 50) / 100;
    out[i] = (uint16_t)std::min(255L, std::max(1L, v));
  }
}

// libjpeg-turbo's compute_reciprocal for a 16-bit DCTELEM: the divisor as
// a reciprocal, a rounding correction and a shift
struct Divisor {
  uint32_t recip, corr;
  int shift;
};

Divisor reciprocal(uint32_t divisor) {
  int b = 0;
  while ((divisor >> (b + 1)) != 0) b++;  // floor(log2(divisor))
  int r = 16 + b;
  uint32_t fq = (uint32_t)((1ULL << r) / divisor);
  const uint32_t fr = (uint32_t)((1ULL << r) % divisor);
  uint32_t c = divisor / 2;
  if (fr == 0) {  // a power of two
    fq >>= 1;
    r--;
  } else if (fr <= divisor / 2) {
    c++;
  } else {
    fq++;
  }
  return {fq, c, r};
}

// jfdctint.c, the islow forward DCT, in place; the output is scaled by 8
const int kConstBits = 13;
const int kPass1Bits = 2;
inline int32_t descale(int32_t x, int n) { return (x + (1 << (n - 1))) >> n; }

void fdct_islow(int32_t* data) {
  const int32_t c0298 = 2446, c0390 = 3196, c0541 = 4433, c0765 = 6270, c0899 = 7373,
                c1175 = 9633, c1501 = 12299, c1847 = 15137, c1961 = 16069, c2053 = 16819,
                c2562 = 20995, c3072 = 25172;
  for (int pass = 0; pass < 2; pass++) {
    const int step = pass == 0 ? 1 : 8, stride = pass == 0 ? 8 : 1;
    const int shift_even = pass == 0 ? 0 : kPass1Bits;
    const int shift_odd = pass == 0 ? kConstBits - kPass1Bits : kConstBits + kPass1Bits;
    for (int line = 0; line < 8; line++) {
      int32_t* d = data + line * stride;
      const int32_t tmp0 = d[0] + d[7 * step], tmp7 = d[0] - d[7 * step];
      const int32_t tmp1 = d[step] + d[6 * step], tmp6 = d[step] - d[6 * step];
      const int32_t tmp2 = d[2 * step] + d[5 * step], tmp5 = d[2 * step] - d[5 * step];
      const int32_t tmp3 = d[3 * step] + d[4 * step], tmp4 = d[3 * step] - d[4 * step];
      const int32_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
      const int32_t tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
      if (pass == 0) {
        d[0] = (tmp10 + tmp11) * (1 << kPass1Bits);
        d[4 * step] = (tmp10 - tmp11) * (1 << kPass1Bits);
      } else {
        d[0] = descale(tmp10 + tmp11, shift_even);
        d[4 * step] = descale(tmp10 - tmp11, shift_even);
      }
      int32_t z1 = (tmp12 + tmp13) * c0541;
      d[2 * step] = descale(z1 + tmp13 * c0765, shift_odd);
      d[6 * step] = descale(z1 - tmp12 * c1847, shift_odd);
      z1 = tmp4 + tmp7;
      int32_t z2 = tmp5 + tmp6, z3 = tmp4 + tmp6, z4 = tmp5 + tmp7;
      const int32_t z5 = (z3 + z4) * c1175;
      const int32_t t4 = tmp4 * c0298, t5 = tmp5 * c2053, t6 = tmp6 * c3072, t7 = tmp7 * c1501;
      z1 *= -c0899;
      z2 *= -c2562;
      z3 = z3 * -c1961 + z5;
      z4 = z4 * -c0390 + z5;
      d[7 * step] = descale(t4 + z1 + z3, shift_odd);
      d[5 * step] = descale(t5 + z2 + z4, shift_odd);
      d[3 * step] = descale(t6 + z2 + z3, shift_odd);
      d[step] = descale(t7 + z1 + z4, shift_odd);
    }
  }
}

// a component's samples, padded as libjpeg pads them, and its blocks
struct Plane {
  int width = 0, height = 0;  // padded to whole blocks
  std::vector<uint8_t> s;
};

struct Bits {
  std::vector<uint8_t>* out;
  uint64_t buf = 0;
  int n = 0;

  void put(uint32_t code, int size) {
    buf = (buf << size) | (code & ((1u << size) - 1));
    n += size;
    while (n >= 8) {
      const uint8_t byte = (uint8_t)(buf >> (n - 8));
      out->push_back(byte);
      if (byte == 0xFF) out->push_back(0);
      n -= 8;
    }
  }
  // jchuff.c flush_bits: seven one bits, of which the part past a byte is dropped
  void flush() {
    put(0x7F, 7);
    n = 0;
    buf = 0;
  }
};

inline int nbits(int v) {
  int n = 0;
  for (v = v < 0 ? -v : v; v; v >>= 1) n++;
  return n;
}

// quantised coefficients of one 8x8 block at (bx, by) of a plane, natural order
void block_coefs(const Plane& p, int bx, int by, const Divisor* div, int16_t* coef) {
  int32_t data[64];
  for (int y = 0; y < 8; y++) {
    const uint8_t* row = p.s.data() + (size_t)(by * 8 + y) * p.width + bx * 8;
    for (int x = 0; x < 8; x++) data[y * 8 + x] = (int32_t)row[x] - 128;
  }
  fdct_islow(data);
  for (int i = 0; i < 64; i++) {
    // the 16-bit DCTELEM of libjpeg-turbo's SIMD build
    const int32_t v = (int16_t)data[i];
    const uint32_t mag = (uint32_t)(v < 0 ? -v : v) & 0xFFFF;
    const uint32_t q = (uint32_t)(((uint64_t)((mag + div[i].corr) & 0xFFFF) * div[i].recip)
                                  >> div[i].shift);
    coef[i] = (int16_t)(v < 0 ? -(int32_t)q : (int32_t)q);
  }
}

void encode_block(Bits& bits, const int16_t* coef, int& last_dc, const HuffTable& dc,
                  const HuffTable& ac) {
  const int diff = coef[0] - last_dc;
  last_dc = coef[0];
  int nb = nbits(diff);
  bits.put(dc.code[nb], dc.size[nb]);
  if (nb) bits.put((uint32_t)(diff < 0 ? diff - 1 : diff), nb);
  int run = 0;
  for (int k = 1; k < 64; k++) {
    const int v = coef[kNatural[k]];
    if (v == 0) {
      run++;
      continue;
    }
    while (run > 15) {
      bits.put(ac.code[0xF0], ac.size[0xF0]);
      run -= 16;
    }
    nb = nbits(v);
    const int sym = (run << 4) | nb;
    bits.put(ac.code[sym], ac.size[sym]);
    bits.put((uint32_t)(v < 0 ? v - 1 : v), nb);
    run = 0;
  }
  if (run > 0) bits.put(ac.code[0], ac.size[0]);
}

void put16(std::vector<uint8_t>& o, int v) {
  o.push_back((uint8_t)(v >> 8));
  o.push_back((uint8_t)v);
}

void marker_dqt(std::vector<uint8_t>& o, int index, const uint16_t* q) {
  o.push_back(0xFF);
  o.push_back(0xDB);
  put16(o, 67);
  o.push_back((uint8_t)index);
  for (int k = 0; k < 64; k++) o.push_back((uint8_t)q[kNatural[k]]);
}

void marker_dht(std::vector<uint8_t>& o, int cls_index, const HuffTable& t) {
  o.push_back(0xFF);
  o.push_back(0xC4);
  put16(o, 2 + 1 + 16 + t.nvals);
  o.push_back((uint8_t)cls_index);
  o.insert(o.end(), t.bits, t.bits + 16);
  o.insert(o.end(), t.vals, t.vals + t.nvals);
}

struct Scratch {
  Plane y, cb, cr;
  std::vector<uint8_t> ccb, ccr;  // full-size chroma rows before the downsample
  std::vector<uint8_t> file;
};

// the JPEG stream of one h x w RGB image
void encode(const uint8_t* rgb, int h, int w, const uint16_t* qluma, const uint16_t* qchroma,
            const Divisor* dluma, const Divisor* dchroma, Scratch& sc) {
  const int mcu_cols = (w + 15) / 16, mcu_rows = (h + 15) / 16;
  const int luma_bw = (w + 7) / 8, luma_bh = (h + 7) / 8;
  // luma: columns to luma_bw * 8, rows to luma_bh * 8, edges replicated
  Plane& py = sc.y;
  py.width = luma_bw * 8;
  py.height = luma_bh * 8;
  py.s.resize((size_t)py.width * py.height);
  // chroma: full-size rows of width mcu_cols * 16 and an even count, then
  // downsampled to mcu_cols * 8 x mcu_rows * 8
  const int cw = mcu_cols * 16, ch = h + (h & 1);
  sc.ccb.resize((size_t)cw * ch);
  sc.ccr.resize((size_t)cw * ch);
  for (int y = 0; y < h; y++) {
    const uint8_t* src = rgb + (size_t)y * w * 3;
    uint8_t* oy = py.s.data() + (size_t)y * py.width;
    uint8_t* ob = sc.ccb.data() + (size_t)y * cw;
    uint8_t* orr = sc.ccr.data() + (size_t)y * cw;
    for (int x = 0; x < w; x++) {
      const int r = src[3 * x], g = src[3 * x + 1], b = src[3 * x + 2];
      oy[x] = (uint8_t)((kColor.ry[r] + kColor.gy[g] + kColor.by[b]) >> kScaleBits);
      ob[x] = (uint8_t)((kColor.rcb[r] + kColor.gcb[g] + kColor.bcb[b]) >> kScaleBits);
      orr[x] = (uint8_t)((kColor.bcb[r] + kColor.gcr[g] + kColor.bcr[b]) >> kScaleBits);
    }
    std::fill(oy + w, oy + py.width, oy[w - 1]);
    std::fill(ob + w, ob + cw, ob[w - 1]);
    std::fill(orr + w, orr + cw, orr[w - 1]);
  }
  for (int y = h; y < py.height; y++)
    std::memcpy(py.s.data() + (size_t)y * py.width, py.s.data() + (size_t)(h - 1) * py.width,
                py.width);
  if (ch > h) {
    std::memcpy(sc.ccb.data() + (size_t)h * cw, sc.ccb.data() + (size_t)(h - 1) * cw, cw);
    std::memcpy(sc.ccr.data() + (size_t)h * cw, sc.ccr.data() + (size_t)(h - 1) * cw, cw);
  }
  Plane* chroma[2] = {&sc.cb, &sc.cr};
  const std::vector<uint8_t>* full[2] = {&sc.ccb, &sc.ccr};
  for (int c = 0; c < 2; c++) {
    Plane& p = *chroma[c];
    p.width = mcu_cols * 8;
    p.height = mcu_rows * 8;
    p.s.resize((size_t)p.width * p.height);
    const int rows = ch / 2;
    for (int y = 0; y < rows; y++) {
      const uint8_t* in0 = full[c]->data() + (size_t)(2 * y) * cw;
      const uint8_t* in1 = in0 + cw;
      uint8_t* o = p.s.data() + (size_t)y * p.width;
      for (int x = 0; x < p.width; x++) {
        const int bias = (x & 1) ? 2 : 1;
        o[x] = (uint8_t)((in0[2 * x] + in0[2 * x + 1] + in1[2 * x] + in1[2 * x + 1] + bias) >> 2);
      }
    }
    for (int y = rows; y < p.height; y++)
      std::memcpy(p.s.data() + (size_t)y * p.width, p.s.data() + (size_t)(rows - 1) * p.width,
                  p.width);
  }

  std::vector<uint8_t>& o = sc.file;
  o.clear();
  static const uint8_t kHead[] = {0xFF, 0xD8, 0xFF, 0xE0, 0x00, 0x10, 'J', 'F', 'I', 'F', 0x00,
                                  0x01, 0x01, 0x00, 0x00, 0x01, 0x00, 0x01, 0x00, 0x00};
  o.insert(o.end(), kHead, kHead + sizeof(kHead));
  marker_dqt(o, 0, qluma);
  marker_dqt(o, 1, qchroma);
  static const uint8_t kSof[] = {0xFF, 0xC0, 0x00, 0x11, 0x08};
  o.insert(o.end(), kSof, kSof + sizeof(kSof));
  put16(o, h);
  put16(o, w);
  static const uint8_t kComps[] = {0x03, 0x01, 0x22, 0x00, 0x02, 0x11, 0x01, 0x03, 0x11, 0x01};
  o.insert(o.end(), kComps, kComps + sizeof(kComps));
  marker_dht(o, 0x00, kDcLuma);
  marker_dht(o, 0x10, kAcLuma);
  marker_dht(o, 0x01, kDcChroma);
  marker_dht(o, 0x11, kAcChroma);
  static const uint8_t kSos[] = {0xFF, 0xDA, 0x00, 0x0C, 0x03, 0x01, 0x00, 0x02,
                                 0x11, 0x03, 0x11, 0x00, 0x3F, 0x00};
  o.insert(o.end(), kSos, kSos + sizeof(kSos));

  Bits bits{&o};
  int dc_y = 0, dc_cb = 0, dc_cr = 0;
  int16_t yb[4][64], cb[64], cr[64];
  for (int my = 0; my < mcu_rows; my++) {
    for (int mx = 0; mx < mcu_cols; mx++) {
      for (int k = 0; k < 4; k++) {
        const int by = 2 * my + k / 2, bx = 2 * mx + k % 2;
        if (by < luma_bh && bx < luma_bw) {
          block_coefs(py, bx, by, dluma, yb[k]);
        } else {
          // a dummy block: AC zero, the DC of the block before it (the
          // one to the left past the right edge; below the last block
          // row, the upper row's last block for both)
          std::memset(yb[k], 0, sizeof(yb[k]));
          yb[k][0] = by < luma_bh ? yb[k - 1][0] : yb[1][0];
        }
      }
      block_coefs(sc.cb, mx, my, dchroma, cb);
      block_coefs(sc.cr, mx, my, dchroma, cr);
      for (int k = 0; k < 4; k++) encode_block(bits, yb[k], dc_y, kDcLuma, kAcLuma);
      encode_block(bits, cb, dc_cb, kDcChroma, kAcChroma);
      encode_block(bits, cr, dc_cr, kDcChroma, kAcChroma);
    }
  }
  bits.flush();
  o.push_back(0xFF);
  o.push_back(0xD9);
}

struct Job {
  const char* const* paths;
  const uint8_t* images;
  int n, h, w;
  uint16_t qluma[64], qchroma[64];
  Divisor dluma[64], dchroma[64];
  int32_t* status;
  std::atomic<int> next{0};
  std::atomic<int> failed{0};
};

int write_one(const Job* job, int i, Scratch& sc) {
  encode(job->images + (size_t)i * job->h * job->w * 3, job->h, job->w, job->qluma,
         job->qchroma, job->dluma, job->dchroma, sc);
  FILE* f = std::fopen(job->paths[i], "wb");
  if (!f) return kOpenError;
  const size_t put = std::fwrite(sc.file.data(), 1, sc.file.size(), f);
  const int closed = std::fclose(f);
  return put != sc.file.size() || closed != 0 ? kWriteError : kOk;
}

void worker(Job* job) {
  Scratch scratch;
  while (true) {
    const int i = job->next.fetch_add(1);
    if (i >= job->n) return;
    int st;
    try {
      st = write_one(job, i, scratch);
    } catch (const std::bad_alloc&) {
      st = kTooLarge;
    }
    job->status[i] = st;
    if (st) job->failed.fetch_add(1);
  }
}

}  // namespace

extern "C" int vdqn_jpeg_encode_batch(const char* const* paths, int n, const uint8_t* images,
                                      int height, int width, int quality, int32_t* status,
                                      int n_threads) {
  if (n <= 0) return 0;
  // a baseline frame holds at most 65,535 rows and columns
  if (height <= 0 || width <= 0 || height > 65535 || width > 65535 || quality < 1 ||
      quality > 100) {
    for (int i = 0; i < n; i++) status[i] = kBadArgument;
    return n;
  }
  Job job;
  job.paths = paths;
  job.images = images;
  job.n = n;
  job.h = height;
  job.w = width;
  job.status = status;
  quant_table(kLumaQuant, quality, job.qluma);
  quant_table(kChromaQuant, quality, job.qchroma);
  for (int i = 0; i < 64; i++) {
    job.dluma[i] = reciprocal((uint32_t)job.qluma[i] << 3);
    job.dchroma[i] = reciprocal((uint32_t)job.qchroma[i] << 3);
  }
  const int hw = (int)std::thread::hardware_concurrency();
  if (n_threads <= 0) n_threads = hw > 0 ? hw : 1;
  n_threads = std::min(n_threads, n);
  if (n_threads == 1) {
    worker(&job);
  } else {
    std::vector<std::thread> threads;
    threads.reserve(n_threads);
    for (int t = 0; t < n_threads; t++) threads.emplace_back(worker, &job);
    for (auto& th : threads) th.join();
  }
  return job.failed.load();
}
