// Batched baseline JPEG decode + resize + centre crop for the training
// infeed, written from the JPEG standard (ITU-T T.81) with no codec library.
//
// Counterpart of the JAX package's native stage (native/decode/jpeg.cc,
// libjpeg-turbo + swscale) and of its PIL twin `_load_image`
// (video_dqn_tpu/data/qlearning.py:31-46), which it reproduces per image:
//   * scaled decode as PIL's Image.draft("RGB", (size, size)) asks of
//     libjpeg: scale 1/s with s the largest of 8, 4, 2, 1 not above
//     min(W // size, H // size), output ceil(W / s) x ceil(H / s). A block's
//     8 / s outputs are the means of s x s pixels of its full IDCT (what
//     libjpeg's reduced IDCTs compute), evaluated in float;
//   * chroma as libjpeg-turbo scales it: a subsampled component is decoded
//     with a larger IDCT where that makes it full size (4:2:0 at 1/2 takes
//     the 8x8 IDCT), else upsampled by 2 with libjpeg's "fancy" triangle
//     filters (h2v1, h1v2, h2v2; plain replication at 1/8 scale);
//   * JFIF YCbCr -> RGB with libjpeg's fixed-point tables; grayscale to
//     R = G = B; 3-component files marked RGB (Adobe transform 0 or
//     component ids 'R','G','B') are not converted;
//   * PIL's BILINEAR resize of the smallest edge to `size` (the
//     round-half-even target of jpeg.cc resize_dims): the antialiased
//     triangle filter with support scaled by the reduction, 22-bit
//     fixed-point coefficients, horizontal pass then vertical, each
//     rounded to uint8; only the rows and columns of the centre crop are
//     computed.
// Markers: SOF0/SOF1 at 8 bits, DHT, DQT (8 and 16 bit), DRI and RSTn,
// SOS (interleaved or one component), APPn/COM skipped. Progressive or
// lossless frames, arithmetic coding, 12-bit samples, 2 or 4 components
// and truncated streams fail with a code (the caller names the file);
// there is no fallback decoder.
//
// C ABI (ctypes; video_dqn_tpu_torch/data/jpeg.py):
//   int vdqn_jpeg_decode_batch(const char* const* paths, int n, int size,
//                              uint8_t* out,      // n * size * size * 3
//                              int32_t* status,   // n codes, 0 = decoded
//                              int n_threads);    // 0 = every hardware thread
//   returns the number of images that failed.

#include <algorithm>
#include <atomic>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <new>
#include <thread>
#include <vector>

namespace {

// status codes, named in data/jpeg.py STATUS
enum Status {
  kOk = 0,
  kReadError = 1,
  kNotJpeg = 2,
  kProgressive = 3,
  kArithmetic = 4,
  kPrecision = 5,
  kComponents = 6,
  kCorrupt = 7,
  kSampling = 8,
  kTruncated = 9,
  kUnsupportedFrame = 10,
  kTooLarge = 11,
};

// frames above this many pixels are refused before anything is allocated
const long kMaxPixels = 1L << 28;

const int kNatural[64] = {0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18,
                          11, 4,  5,  12, 19, 26, 33, 40, 48, 41, 34, 27, 20,
                          13, 6,  7,  14, 21, 28, 35, 42, 49, 56, 57, 50, 43,
                          36, 29, 22, 15, 23, 30, 37, 44, 51, 58, 59, 52, 45,
                          38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63};

// kBasis[k][u][m]: output m of an IDCT of 2^k outputs from coefficient u,
// the mean of the full 8-point IDCT's basis over the 8 / 2^k pixels m stands
// for, with the C(u) / 2 normalisation folded in
struct Basis {
  float b[4][8][8];
  Basis() {
    const double pi = 3.14159265358979323846;
    for (int k = 0; k < 4; k++) {
      const int n = 1 << k, s = 8 / n;
      for (int u = 0; u < 8; u++)
        for (int m = 0; m < 8; m++) {
          double sum = 0;
          for (int j = 0; j < s && m < n; j++)
            sum += std::cos((2 * (s * m + j) + 1) * u * pi / 16);
          b[k][u][m] = (float)(sum / s * (u == 0 ? std::sqrt(0.5) : 1.0) / 2);
        }
    }
  }
};
const Basis kBasis;

int log2_of(int n) { return n == 1 ? 0 : n == 2 ? 1 : n == 4 ? 2 : 3; }

struct Huffman {
  bool defined = false;
  uint8_t vals[256];
  int32_t maxcode[17];    // largest code of each length, -1 if none
  int32_t valoffset[17];  // vals index of a code = code + valoffset[length]
  uint16_t fast[1 << 9];  // (length << 8) | value for codes up to 9 bits
};

bool build_huffman(Huffman& h, const uint8_t* counts, const uint8_t* vals,
                   int nvals) {
  std::memcpy(h.vals, vals, nvals);
  std::memset(h.fast, 0, sizeof(h.fast));
  int code = 0, k = 0;
  for (int len = 1; len <= 16; len++) {
    const int n = counts[len - 1];
    h.valoffset[len] = k - code;
    for (int j = 0; j < n; j++, code++, k++) {
      if (code >= (1 << len)) return false;  // over-subscribed
      if (len <= 9) {
        const int shift = 9 - len;
        for (int fill = 0; fill < (1 << shift); fill++)
          h.fast[(code << shift) | fill] = (uint16_t)((len << 8) | vals[k]);
      }
    }
    h.maxcode[len] = n ? code - 1 : -1;
    code <<= 1;
  }
  h.defined = true;
  return true;
}

// Entropy-coded data: bytes with FF 00 stuffing, ended by a marker. Past a
// marker it feeds zero bits, as libjpeg does; past the end of the file it
// sets `eof`, which the scan reports as truncation.
struct BitReader {
  const uint8_t* p;
  const uint8_t* end;
  uint64_t acc = 0;
  int bits = 0;
  int marker = 0;
  bool eof = false;

  void refill() {
    // fast path: bytes that hold no FF go in without the marker checks
    while (bits <= 56 && marker == 0 && p < end && *p != 0xFF) {
      acc |= (uint64_t)*p++ << (56 - bits);
      bits += 8;
    }
    while (bits <= 56) {
      uint32_t b = 0;
      if (marker == 0 && !eof) {
        if (p >= end) {
          eof = true;
        } else if (*p != 0xFF) {
          b = *p++;
        } else {
          const uint8_t* q = p + 1;
          while (q < end && *q == 0xFF) q++;  // fill bytes
          if (q >= end) {
            eof = true;
          } else if (*q == 0) {
            b = 0xFF;
            p = q + 1;
          } else {
            marker = *q;
            p = q + 1;
          }
        }
      }
      acc |= (uint64_t)b << (56 - bits);
      bits += 8;
    }
  }
  uint32_t bits_of(int n) {  // 1 <= n <= 16
    if (bits < n) refill();
    const uint32_t v = (uint32_t)(acc >> (64 - n));
    acc <<= n;
    bits -= n;
    return v;
  }
  // the next restart marker: drop what is left of the interval's bits and
  // skip to the marker
  int restart_marker() {
    acc = 0;
    bits = 0;
    while (marker == 0 && p < end) {
      if (*p++ != 0xFF) continue;
      while (p < end && *p == 0xFF) p++;
      if (p < end && *p != 0) marker = *p;
      if (p < end) p++;
    }
    const int m = marker;
    marker = 0;
    return m;
  }
};

inline int decode_huffman(BitReader& br, const Huffman& h) {
  if (br.bits < 16) br.refill();
  const uint16_t e = h.fast[br.acc >> (64 - 9)];
  if (e) {
    const int len = e >> 8;
    br.acc <<= len;
    br.bits -= len;
    return e & 0xFF;
  }
  const uint32_t code16 = (uint32_t)(br.acc >> 48);
  for (int len = 10; len <= 16; len++) {
    const int32_t code = (int32_t)(code16 >> (16 - len));
    if (code <= h.maxcode[len]) {
      br.acc <<= len;
      br.bits -= len;
      return h.vals[code + h.valoffset[len]];
    }
  }
  return -1;
}

inline int extend(uint32_t v, int s) {
  return v < (1u << (s - 1)) ? (int)v - (1 << s) + 1 : (int)v;
}

struct Component {
  int id, h, v, tq, td, ta;
  int ssize;      // IDCT outputs per block side
  int bw, bh;     // blocks across and down in the plane (MCU-padded)
  int stride;     // plane width, bw * ssize
  int dw, dh;     // valid samples at the scaled size
  int fh, fv;     // upsampling to the output: 1 or 2 each
  int bx0, bx1, by0, by1;  // the blocks the centre crop reads
  int pred;       // DC predictor
  bool seen;      // decoded by a scan
  std::vector<uint8_t>* plane;
};

struct Scratch {
  std::vector<uint8_t> file, rgb, tmp;
  std::vector<uint8_t> planes[3], rows[3];
  std::vector<int32_t> kx, ky;
};

inline uint8_t clamp255(int v) { return (uint8_t)(v < 0 ? 0 : v > 255 ? 255 : v); }

// One block's IDCT to n x n pixels: rows of coefficients first (only the
// rows that hold a nonzero one, only up to the last nonzero column), then
// columns, each an 8-wide multiply-add over the outputs.
void idct_block(const int32_t* coef, unsigned rowmask, int last_col, bool dc_only, int n,
                uint8_t* dst, int stride) {
  if (dc_only) {
    const uint8_t v = clamp255((int)(coef[0] / 8.0f + 128.5f));
    for (int y = 0; y < n; y++) std::memset(dst + (size_t)y * stride, v, n);
    return;
  }
  const float(*b)[8] = kBasis.b[log2_of(n)];
  float tmp[8][8];
  int rows[8], nrows = 0;
  for (int v = 0; v < 8; v++) {
    if (!((rowmask >> v) & 1)) continue;
    rows[nrows++] = v;
    const int32_t* row = coef + 8 * v;
    float acc[8] = {0, 0, 0, 0, 0, 0, 0, 0};
    for (int u = 0; u <= last_col; u++) {
      const float c = (float)row[u];
      for (int x = 0; x < 8; x++) acc[x] += c * b[u][x];
    }
    for (int x = 0; x < 8; x++) tmp[v][x] = acc[x];
  }
  for (int y = 0; y < n; y++) {
    float acc[8] = {0, 0, 0, 0, 0, 0, 0, 0};
    for (int i = 0; i < nrows; i++) {
      const float c = b[rows[i]][y];
      for (int x = 0; x < 8; x++) acc[x] += c * tmp[rows[i]][x];
    }
    uint8_t* out = dst + (size_t)y * stride;
    // truncation rounds as floor does wherever the result is not clamped to 0
    for (int x = 0; x < n; x++) out[x] = clamp255((int)(acc[x] + 128.5f));
  }
}

// _load_image's target: the smallest edge to `size`, round half to even
void resize_dims(int w, int h, int size, int* nw, int* nh) {
  if (h <= w) {
    *nh = size;
    *nw = std::max(size, (int)std::nearbyint((double)size * w / h));
  } else {
    *nw = size;
    *nh = std::max(size, (int)std::nearbyint((double)size * h / w));
  }
}

// Pillow's Resample.c precompute_coeffs for the bilinear filter: the scale
// and support of a resample of in_size to out_size, and the input pixels
// [xmin, xmin + count) that output xx reads.
struct Resample {
  double scale, filterscale, support;
  Resample(int in_size, int out_size) {
    scale = (double)in_size / out_size;
    filterscale = scale < 1.0 ? 1.0 : scale;
    support = 1.0 * filterscale;
  }
  void bounds(int xx, int in_size, double* center, int* xmin, int* count) const {
    *center = (xx + 0.5) * scale;
    *xmin = (int)(*center - support + 0.5);
    if (*xmin < 0) *xmin = 0;
    int xmax = (int)(*center + support + 0.5);
    if (xmax > in_size) xmax = in_size;
    *count = xmax - *xmin;
  }
};

// Pillow's bilinear coefficients for outputs [first, first + count) of a
// resample of in_size to out_size, with normalize_coeffs_8bpc's 22-bit
// fixed point. coeffs holds per output: xmin, count, then ksize weights.
const int kPrecisionBits = 32 - 8 - 2;

int resample_coeffs(int in_size, int out_size, int first, int count,
                    std::vector<int32_t>& coeffs) {
  const Resample r(in_size, out_size);
  const int ksize = (int)std::ceil(r.support) * 2 + 1;
  coeffs.assign((size_t)count * (ksize + 2), 0);
  std::vector<double> k(ksize);
  for (int i = 0; i < count; i++) {
    double center;
    int xmin, n;
    r.bounds(first + i, in_size, &center, &xmin, &n);
    const double ss = 1.0 / r.filterscale;
    double ww = 0.0;
    for (int x = 0; x < n; x++) {
      double arg = (x + xmin - center + 0.5) * ss;
      if (arg < 0.0) arg = -arg;
      const double w = arg < 1.0 ? 1.0 - arg : 0.0;
      k[x] = w;
      ww += w;
    }
    int32_t* row = coeffs.data() + (size_t)i * (ksize + 2);
    row[0] = xmin;
    row[1] = n;
    for (int x = 0; x < n; x++) {
      const double w = ww != 0.0 ? k[x] / ww : k[x];
      row[2 + x] = w < 0 ? (int32_t)(-0.5 + w * (1 << kPrecisionBits))
                         : (int32_t)(0.5 + w * (1 << kPrecisionBits));
    }
  }
  return ksize;
}

// The resize of the scaled (w, h) image to its centre crop, planned before
// the decode: the coefficients into scratch.kx / scratch.ky, which
// resize_crop applies, and from those same tables the columns [x0, x1) and
// rows [y0, y1) the crop reads (a later output's xmin and xmin + count are
// never smaller), the only ones the IDCT and the colour conversion compute.
struct Crop {
  int w, h;            // the scaled image
  int nw, nh;          // resized: the smallest edge to size
  int left, top;       // the crop's corner in the resized image
  int kx, ky;          // int32 entries per output in scratch.kx / scratch.ky
  int x0, x1, y0, y1;  // the scaled image's pixels the crop reads
};

Crop plan_crop(int w, int h, int size, std::vector<int32_t>& kx,
               std::vector<int32_t>& ky) {
  Crop c;
  c.w = w;
  c.h = h;
  resize_dims(w, h, size, &c.nw, &c.nh);
  c.left = (c.nw - size) / 2;
  c.top = (c.nh - size) / 2;
  c.kx = resample_coeffs(w, c.nw, c.left, size, kx) + 2;
  c.ky = resample_coeffs(h, c.nh, c.top, size, ky) + 2;
  const int32_t* last_x = kx.data() + (size_t)(size - 1) * c.kx;
  const int32_t* last_y = ky.data() + (size_t)(size - 1) * c.ky;
  c.x0 = kx[0];
  c.x1 = last_x[0] + last_x[1];
  c.y0 = ky[0];
  c.y1 = last_y[0] + last_y[1];
  return c;
}

struct Decoder {
  const uint8_t* data;
  size_t len;
  size_t pos = 0;
  int size;  // the crop side the caller asked for
  Scratch& scratch;
  uint16_t q[4][64];
  bool qdef[4] = {false, false, false, false};
  Huffman dc[4], ac[4];
  int restart = 0;
  int width = 0, height = 0, ncomp = 0, hmax = 1, vmax = 1;
  int n = 8;  // IDCT outputs per block side of the largest-sampled component
  int mcux = 0, mcuy = 0;
  Crop crop{};  // the resize to the centre crop, planned at the SOF
  bool frame = false, saw_jfif = false;
  int adobe_transform = -1;  // -1: no Adobe APP14 marker
  Component comp[3];

  Decoder(const uint8_t* d, size_t l, int s, Scratch& sc)
      : data(d), len(l), size(s), scratch(sc) {}

  int u16(size_t at) const { return (data[at] << 8) | data[at + 1]; }

  int parse_sof() {
    const int seg = u16(pos);
    if (pos + seg > len || seg < 8) return kTruncated;
    if (data[pos + 2] != 8) return kPrecision;
    height = u16(pos + 3);
    width = u16(pos + 5);
    ncomp = data[pos + 7];
    if (ncomp != 1 && ncomp != 3) return kComponents;
    if (width == 0 || height == 0 || seg < 8 + 3 * ncomp) return kCorrupt;
    if ((long)width * height > kMaxPixels) return kTooLarge;
    for (int c = 0; c < ncomp; c++) {
      const uint8_t* p = data + pos + 8 + 3 * c;
      Component& k = comp[c];
      k = Component{};
      k.id = p[0];
      k.h = p[1] >> 4;
      k.v = p[1] & 15;
      k.tq = p[2] & 3;
      if (k.h < 1 || k.h > 4 || k.v < 1 || k.v > 4) return kSampling;
    }
    if (ncomp == 1) comp[0].h = comp[0].v = 1;  // one component: no MCU interleave
    hmax = vmax = 1;
    for (int c = 0; c < ncomp; c++) {
      hmax = std::max(hmax, comp[c].h);
      vmax = std::max(vmax, comp[c].v);
    }
    // PIL's draft: the largest 1/s, s in 8, 4, 2, 1, not above
    // min(W // size, H // size)
    const int scale = std::min(width / size, height / size);
    int s = 8;
    while (s > 1 && s > scale) s /= 2;
    n = 8 / s;
    crop = plan_crop((width + s - 1) / s, (height + s - 1) / s, size, scratch.kx, scratch.ky);
    mcux = (width + 8 * hmax - 1) / (8 * hmax);
    mcuy = (height + 8 * vmax - 1) / (8 * vmax);
    for (int c = 0; c < ncomp; c++) {
      Component& k = comp[c];
      // libjpeg-turbo's choice: scale a subsampled component up through
      // the IDCT while that keeps whole factors of two
      k.ssize = n;
      while (k.ssize < 8 && (hmax * n) % (k.h * k.ssize * 2) == 0 &&
             (vmax * n) % (k.v * k.ssize * 2) == 0)
        k.ssize *= 2;
      if ((hmax * n) % (k.h * k.ssize) || (vmax * n) % (k.v * k.ssize))
        return kSampling;
      k.fh = hmax * n / (k.h * k.ssize);
      k.fv = vmax * n / (k.v * k.ssize);
      if (k.fh > 2 || k.fv > 2) return kSampling;
      k.bw = mcux * k.h;
      k.bh = mcuy * k.v;
      k.stride = k.bw * k.ssize;
      k.dw = (int)(((long)width * k.h * k.ssize + hmax * 8 - 1) / (hmax * 8));
      k.dh = (int)(((long)height * k.v * k.ssize + vmax * 8 - 1) / (vmax * 8));
      // blocks under that span, one more each side for the upsampling's
      // neighbours; the IDCT skips the others
      const int px = k.fh * k.ssize, py = k.fv * k.ssize;
      k.bx0 = std::max(0, crop.x0 / px - 1);
      k.bx1 = std::min(k.bw, (crop.x1 + px - 1) / px + 1);
      k.by0 = std::max(0, crop.y0 / py - 1);
      k.by1 = std::min(k.bh, (crop.y1 + py - 1) / py + 1);
      k.plane = &scratch.planes[c];
      const size_t bytes = (size_t)k.stride * k.bh * k.ssize;
      if (k.plane->size() < bytes) k.plane->resize(bytes);
      std::memset(k.plane->data(), 0, bytes);
    }
    frame = true;
    return kOk;
  }

  int parse_dqt() {
    const size_t end = pos + u16(pos);
    if (end > len) return kTruncated;
    size_t p = pos + 2;
    while (p < end) {
      const int pq = data[p] >> 4, tq = data[p] & 15;
      p++;
      if (tq > 3 || pq > 1 || p + 64 * (pq + 1) > end) return kCorrupt;
      for (int k = 0; k < 64; k++) {
        q[tq][k] = pq ? (uint16_t)u16(p) : data[p];
        p += pq + 1;
      }
      qdef[tq] = true;
    }
    return kOk;
  }

  int parse_dht() {
    const size_t end = pos + u16(pos);
    if (end > len) return kTruncated;
    size_t p = pos + 2;
    while (p < end) {
      if (p + 17 > end) return kCorrupt;
      const int tc = data[p] >> 4, th = data[p] & 15;
      const uint8_t* counts = data + p + 1;
      int total = 0;
      for (int i = 0; i < 16; i++) total += counts[i];
      p += 17;
      if (tc > 1 || th > 3 || total > 256 || p + total > end) return kCorrupt;
      if (!build_huffman(tc ? ac[th] : dc[th], counts, data + p, total)) return kCorrupt;
      p += total;
    }
    return kOk;
  }

  int decode_block(BitReader& br, Component& k, int bx, int by) {
    const Huffman& hd = dc[k.td];
    const Huffman& ha = ac[k.ta];
    const uint16_t* qt = q[k.tq];
    int32_t coef[64] = {0};
    const int t = decode_huffman(br, hd);
    if (t < 0 || t > 16) return kCorrupt;
    if (t) k.pred += extend(br.bits_of(t), t);
    coef[0] = k.pred * qt[0];
    unsigned rowmask = 1;
    int last_col = 0;
    bool dc_only = true;
    for (int i = 1; i < 64;) {
      const int rs = decode_huffman(br, ha);
      if (rs < 0) return kCorrupt;
      const int r = rs >> 4, s = rs & 15;
      if (s == 0) {
        if (r != 15) break;  // end of block
        i += 16;
        continue;
      }
      i += r;
      if (i > 63) return kCorrupt;
      const int at = kNatural[i];
      coef[at] = extend(br.bits_of(s), s) * qt[i];
      rowmask |= 1u << (at >> 3);
      last_col = std::max(last_col, at & 7);
      dc_only = false;
      i++;
    }
    if (bx < k.bx0 || bx >= k.bx1 || by < k.by0 || by >= k.by1) return kOk;
    uint8_t* dst = k.plane->data() + (size_t)by * k.ssize * k.stride + (size_t)bx * k.ssize;
    idct_block(coef, rowmask, last_col, dc_only, k.ssize, dst, k.stride);
    return kOk;
  }

  int parse_sos() {
    if (!frame) return kCorrupt;
    const size_t seg = u16(pos);
    if (pos + seg > len) return kTruncated;
    const int ns = data[pos + 2];
    if (ns < 1 || ns > ncomp || seg != (size_t)6 + 2 * ns) return kCorrupt;
    Component* scan[3];
    for (int i = 0; i < ns; i++) {
      const int id = data[pos + 3 + 2 * i];
      const int tables = data[pos + 4 + 2 * i];
      scan[i] = nullptr;
      for (int c = 0; c < ncomp; c++)
        if (comp[c].id == id) scan[i] = &comp[c];
      if (!scan[i]) return kCorrupt;
      scan[i]->td = tables >> 4;
      scan[i]->ta = tables & 15;
      if (scan[i]->td > 3 || scan[i]->ta > 3 || !dc[scan[i]->td].defined ||
          !ac[scan[i]->ta].defined || !qdef[scan[i]->tq])
        return kCorrupt;
      scan[i]->pred = 0;
      scan[i]->seen = true;
    }
    const size_t spec = pos + 3 + 2 * ns;
    if (data[spec] != 0 || data[spec + 1] != 63 || data[spec + 2] != 0) return kCorrupt;
    pos += seg;

    BitReader br{data + pos, data + len};
    // one component alone: MCUs of one block over its own extent,
    // ceil(W * h / hmax / 8) x ceil(H * v / vmax / 8)
    const bool single = ns == 1;
    const int cols = single ? (width * scan[0]->h + hmax * 8 - 1) / (hmax * 8) : mcux;
    const int rows = single ? (height * scan[0]->v + vmax * 8 - 1) / (vmax * 8) : mcuy;
    const long total = (long)cols * rows;
    int next_rst = 0;
    for (long m = 0; m < total; m++) {
      if (restart && m > 0 && m % restart == 0) {
        if (br.eof) return kTruncated;
        if (br.restart_marker() != 0xD0 + next_rst) return kCorrupt;
        next_rst = (next_rst + 1) & 7;
        for (int i = 0; i < ns; i++) scan[i]->pred = 0;
      }
      const int mx = (int)(m % cols), my = (int)(m / cols);
      for (int i = 0; i < ns; i++) {
        Component& k = *scan[i];
        if (single) {
          const int st = decode_block(br, k, mx, my);
          if (st) return st;
          continue;
        }
        for (int by = 0; by < k.v; by++)
          for (int bx = 0; bx < k.h; bx++) {
            const int st = decode_block(br, k, mx * k.h + bx, my * k.v + by);
            if (st) return st;
          }
      }
    }
    // the scan must end at a marker, not at the end of the file
    while (br.marker == 0 && !br.eof) {
      br.acc = 0;
      br.bits = 0;
      br.refill();
    }
    if (br.marker == 0) return kTruncated;
    pos = (size_t)(br.p - data) - 2;  // the FF before the marker's code
    return kOk;
  }

  int parse() {
    if (len < 4 || data[0] != 0xFF || data[1] != 0xD8) return kNotJpeg;
    pos = 2;
    while (true) {
      while (pos < len && data[pos] != 0xFF) pos++;  // garbage between markers
      while (pos < len && data[pos] == 0xFF) pos++;
      if (pos >= len) return kTruncated;
      const int m = data[pos++];
      if (m == 0xD9) break;  // EOI
      if ((m >= 0xD0 && m <= 0xD7) || m == 0x01) continue;  // no length
      if (pos + 2 > len) return kTruncated;
      int st = kOk;
      if (m == 0xC0 || m == 0xC1) {
        st = parse_sof();
      } else if (m == 0xC2) {
        return kProgressive;
      } else if (m == 0xC3 || (m >= 0xC5 && m <= 0xC8)) {
        return kUnsupportedFrame;  // lossless, differential, reserved
      } else if (m >= 0xC9 && m <= 0xCF) {
        return kArithmetic;  // arithmetic-coded frames and DAC
      } else if (m == 0xC4) {
        st = parse_dht();
      } else if (m == 0xDB) {
        st = parse_dqt();
      } else if (m == 0xDD) {
        if (u16(pos) < 4 || pos + 4 > len) return kCorrupt;
        restart = u16(pos + 2);
      } else if (m == 0xDA) {
        st = parse_sos();
        if (st) return st;
        continue;  // pos is at the marker that ended the scan
      } else if (m == 0xE0 && u16(pos) >= 7 && pos + 7 <= len &&
                 std::memcmp(data + pos + 2, "JFIF", 5) == 0) {
        saw_jfif = true;
      } else if (m == 0xEE && u16(pos) >= 14 && pos + 14 <= len &&
                 std::memcmp(data + pos + 2, "Adobe", 5) == 0) {
        adobe_transform = data[pos + 13];
      }
      if (st) return st;
      pos += u16(pos);
      if (pos > len) return kTruncated;
    }
    if (!frame) return kCorrupt;
    for (int c = 0; c < ncomp; c++)
      if (!comp[c].seen) return kTruncated;
    return kOk;
  }

  // component c's samples of output row y, upsampled to the output width
  const uint8_t* upsampled_row(int c, int y, int out_w) {
    Component& k = comp[c];
    const uint8_t* plane = k.plane->data();
    if (k.fh == 1 && k.fv == 1) return plane + (size_t)y * k.stride;
    std::vector<uint8_t>& row = scratch.rows[c];
    if (row.size() < (size_t)out_w + 4) row.resize(out_w + 4);
    uint8_t* out = row.data();
    const int iy = y / k.fv;
    const uint8_t* in0 = plane + (size_t)iy * k.stride;
    const bool fancy = n > 1;  // libjpeg: no context rows at 1/8 scale
    const int w = k.dw;
    if (k.fv == 1) {  // h2v1
      if (!fancy || w <= 2) {
        for (int x = 0; x < out_w; x++) out[x] = in0[x >> 1];
        return out;
      }
      out[0] = in0[0];
      out[1] = (uint8_t)((in0[0] * 3 + in0[1] + 2) >> 2);
      for (int i = 1; i < w - 1; i++) {
        const int t = in0[i] * 3;
        out[2 * i] = (uint8_t)((t + in0[i - 1] + 1) >> 2);
        out[2 * i + 1] = (uint8_t)((t + in0[i + 1] + 2) >> 2);
      }
      out[2 * w - 2] = (uint8_t)((in0[w - 1] * 3 + in0[w - 2] + 1) >> 2);
      out[2 * w - 1] = in0[w - 1];
      return out;
    }
    // vertical factor 2: the nearer other row, clamped at the edges
    const int other = std::min(std::max(iy + ((y & 1) ? 1 : -1), 0), k.dh - 1);
    const uint8_t* in1 = plane + (size_t)other * k.stride;
    if (k.fh == 1) {  // h1v2
      if (!fancy) {
        std::memcpy(out, in0, out_w);
        return out;
      }
      const int bias = (y & 1) ? 2 : 1;
      for (int x = 0; x < w; x++) out[x] = (uint8_t)((in0[x] * 3 + in1[x] + bias) >> 2);
      return out;
    }
    // h2v2
    if (!fancy || w <= 2) {
      for (int x = 0; x < out_w; x++) out[x] = in0[x >> 1];
      return out;
    }
    int last = in0[0] * 3 + in1[0];
    int cur = last;
    int next = in0[1] * 3 + in1[1];
    out[0] = (uint8_t)((cur * 4 + 8) >> 4);
    out[1] = (uint8_t)((cur * 3 + next + 7) >> 4);
    for (int i = 1; i < w - 1; i++) {
      last = cur;
      cur = next;
      next = in0[i + 1] * 3 + in1[i + 1];
      out[2 * i] = (uint8_t)((cur * 3 + last + 8) >> 4);
      out[2 * i + 1] = (uint8_t)((cur * 3 + next + 7) >> 4);
    }
    last = cur;
    cur = next;
    out[2 * w - 2] = (uint8_t)((cur * 3 + last + 8) >> 4);
    out[2 * w - 1] = (uint8_t)((cur * 4 + 7) >> 4);
    return out;
  }

  // the crop's rows [crop.y0, crop.y1) of the scaled image as interleaved
  // RGB into scratch.rgb
  void to_rgb() {
    const int w = crop.w, h = crop.h;
    std::vector<uint8_t>& rgb = scratch.rgb;
    if (rgb.size() < (size_t)w * h * 3) rgb.resize((size_t)w * h * 3);
    // libjpeg jdcolor.c tables: SCALEBITS 16, FIX(x) = x * 65536 + 0.5
    static const struct Tables {
      int cr_r[256], cb_b[256], cr_g[256], cb_g[256];
      Tables() {
        for (int i = 0; i < 256; i++) {
          const long x = i - 128;
          cr_r[i] = (int)((91881L * x + 32768) >> 16);   // FIX(1.40200)
          cb_b[i] = (int)((116130L * x + 32768) >> 16);  // FIX(1.77200)
          cr_g[i] = (int)(-46802L * x);                  // -FIX(0.71414)
          cb_g[i] = (int)(-22554L * x + 32768);          // -FIX(0.34414)
        }
      }
    } t;
    // libjpeg's default_decompress_parms: JFIF means YCbCr, else an Adobe
    // transform of 0 or component ids 'R', 'G', 'B' mean RGB
    const bool rgb_coded =
        !saw_jfif && (adobe_transform >= 0
                          ? adobe_transform == 0
                          : comp[0].id == 'R' && comp[1].id == 'G' && comp[2].id == 'B');
    for (int y = crop.y0; y < crop.y1; y++) {
      uint8_t* out = rgb.data() + (size_t)y * w * 3;
      if (ncomp == 1) {
        const uint8_t* g = upsampled_row(0, y, w);
        for (int x = 0; x < w; x++) out[3 * x] = out[3 * x + 1] = out[3 * x + 2] = g[x];
        continue;
      }
      const uint8_t* c0 = upsampled_row(0, y, w);
      const uint8_t* c1 = upsampled_row(1, y, w);
      const uint8_t* c2 = upsampled_row(2, y, w);
      if (rgb_coded) {
        for (int x = 0; x < w; x++) {
          out[3 * x] = c0[x];
          out[3 * x + 1] = c1[x];
          out[3 * x + 2] = c2[x];
        }
        continue;
      }
      for (int x = 0; x < w; x++) {
        const int yy = c0[x], cb = c1[x], cr = c2[x];
        out[3 * x] = clamp255(yy + t.cr_r[cr]);
        out[3 * x + 1] = clamp255(yy + ((t.cb_g[cb] + t.cr_g[cr]) >> 16));
        out[3 * x + 2] = clamp255(yy + t.cb_b[cb]);
      }
    }
  }
};

inline uint8_t clip8(int32_t in) {
  if (in >= (1 << kPrecisionBits << 8)) return 255;
  if (in <= 0) return 0;
  return (uint8_t)(in >> kPrecisionBits);
}

// PIL's resize of the scaled RGB image to (crop.nw, crop.nh), cropped to
// [left, left + size) x [top, top + size), into out (size * size * 3),
// through the coefficients plan_crop left in scratch
void resize_crop(const uint8_t* rgb, const Crop& crop, int size, uint8_t* out,
                 Scratch& scratch) {
  const int w = crop.w, left = crop.left, top = crop.top;
  const int kx = crop.kx, ky = crop.ky, y0 = crop.y0, y1 = crop.y1;
  const bool horizontal = crop.nw != w, vertical = crop.nh != crop.h;
  std::vector<uint8_t>& tmp = scratch.tmp;
  const int rows = y1 - y0;
  if (tmp.size() < (size_t)rows * size * 3) tmp.resize((size_t)rows * size * 3);
  for (int r = 0; r < rows; r++) {
    const uint8_t* in = rgb + (size_t)(y0 + r) * w * 3;
    uint8_t* t = tmp.data() + (size_t)r * size * 3;
    for (int i = 0; i < size; i++) {
      if (!horizontal) {
        std::memcpy(t + 3 * i, in + 3 * (left + i), 3);
        continue;
      }
      const int32_t* c = scratch.kx.data() + (size_t)i * kx;
      int32_t s0 = 1 << (kPrecisionBits - 1), s1 = s0, s2 = s0;
      const uint8_t* p = in + 3 * c[0];
      for (int x = 0; x < c[1]; x++) {
        s0 += p[3 * x] * c[2 + x];
        s1 += p[3 * x + 1] * c[2 + x];
        s2 += p[3 * x + 2] * c[2 + x];
      }
      t[3 * i] = clip8(s0);
      t[3 * i + 1] = clip8(s1);
      t[3 * i + 2] = clip8(s2);
    }
  }
  const size_t row_bytes = (size_t)size * 3;
  for (int j = 0; j < size; j++) {
    uint8_t* o = out + (size_t)j * row_bytes;
    if (!vertical) {
      std::memcpy(o, tmp.data() + (size_t)(top + j - y0) * row_bytes, row_bytes);
      continue;
    }
    const int32_t* c = scratch.ky.data() + (size_t)j * ky;
    const uint8_t* base = tmp.data() + (size_t)(c[0] - y0) * row_bytes;
    for (size_t i = 0; i < row_bytes; i++) {
      int32_t s = 1 << (kPrecisionBits - 1);
      for (int y = 0; y < c[1]; y++) s += base[(size_t)y * row_bytes + i] * c[2 + y];
      o[i] = clip8(s);
    }
  }
}

int decode_one(const char* path, int size, uint8_t* out, Scratch& scratch) {
  FILE* f = std::fopen(path, "rb");
  if (!f) return kReadError;
  std::fseek(f, 0, SEEK_END);
  const long len = std::ftell(f);
  std::fseek(f, 0, SEEK_SET);
  if (len <= 0) {
    std::fclose(f);
    return len == 0 ? kNotJpeg : kReadError;
  }
  if (scratch.file.size() < (size_t)len) scratch.file.resize(len);
  const size_t got = std::fread(scratch.file.data(), 1, len, f);
  std::fclose(f);
  if (got != (size_t)len) return kReadError;
  Decoder dec(scratch.file.data(), (size_t)len, size, scratch);
  const int st = dec.parse();
  if (st) return st;
  dec.to_rgb();
  resize_crop(scratch.rgb.data(), dec.crop, size, out, scratch);
  return kOk;
}

struct Job {
  const char* const* paths;
  int n, size;
  uint8_t* out;
  int32_t* status;
  std::atomic<int> next{0};
  std::atomic<int> failed{0};
};

void worker(Job* job) {
  const size_t stride = (size_t)job->size * job->size * 3;
  Scratch scratch;
  while (true) {
    const int i = job->next.fetch_add(1);
    if (i >= job->n) return;
    int st;
    try {
      st = decode_one(job->paths[i], job->size, job->out + stride * i, scratch);
    } catch (const std::bad_alloc&) {
      st = kTooLarge;
    }
    job->status[i] = st;
    if (st) job->failed.fetch_add(1);
  }
}

}  // namespace

extern "C" int vdqn_jpeg_decode_batch(const char* const* paths, int n, int size,
                                      uint8_t* out, int32_t* status, int n_threads) {
  if (n <= 0 || size <= 0) return 0;
  Job job;
  job.paths = paths;
  job.n = n;
  job.size = size;
  job.out = out;
  job.status = status;
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
