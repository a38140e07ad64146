// LZ4 frame decoder for the Arrow IPC reader (data/feather.py).
//
// pandas writes feathers (Arrow IPC files) with LZ4_FRAME buffer
// compression by default: each compressed buffer is one LZ4 frame
// (https://github.com/lz4/lz4/blob/dev/doc/lz4_Frame_format.md) holding
// LZ4 blocks (lz4_Block_format.md). Host code, called through ctypes:
//
//   int64_t vdqn_lz4_frame_decode(const uint8_t* src, int64_t src_len,
//                                 uint8_t* dst, int64_t dst_cap);
//
// returns the number of bytes written, or a negative error code:
//   -1 bad magic or frame descriptor, -2 truncated input,
//   -3 output larger than dst_cap, -4 bad match offset, -5 preset dictionary.
// Linked blocks are handled by decoding every block into the one output
// buffer. Checksums are skipped, not verified; the caller checks that the
// decoded size is the size the IPC buffer announces.

#include <cstdint>
#include <cstring>

namespace {

uint32_t le32(const uint8_t* p) {
  return (uint32_t)p[0] | ((uint32_t)p[1] << 8) | ((uint32_t)p[2] << 16) |
         ((uint32_t)p[3] << 24);
}

// one LZ4 block into dst[out..cap); returns the new output position or a
// negative error code
int64_t decode_block(const uint8_t* src, int64_t n, uint8_t* dst, int64_t out,
                     int64_t cap) {
  int64_t i = 0;
  while (i < n) {
    const uint8_t token = src[i++];
    int64_t lit = token >> 4;
    if (lit == 15) {
      uint8_t b;
      do {
        if (i >= n) return -2;
        b = src[i++];
        lit += b;
      } while (b == 255);
    }
    if (i + lit > n) return -2;
    if (out + lit > cap) return -3;
    std::memcpy(dst + out, src + i, (size_t)lit);
    i += lit;
    out += lit;
    if (i == n) break;  // the last sequence has literals only
    if (i + 2 > n) return -2;
    const int64_t offset = (int64_t)src[i] | ((int64_t)src[i + 1] << 8);
    i += 2;
    int64_t len = (token & 15) + 4;
    if ((token & 15) == 15) {
      uint8_t b;
      do {
        if (i >= n) return -2;
        b = src[i++];
        len += b;
      } while (b == 255);
    }
    if (offset == 0 || offset > out) return -4;
    if (out + len > cap) return -3;
    const uint8_t* from = dst + out - offset;
    uint8_t* to = dst + out;
    if (offset >= len) {
      std::memcpy(to, from, (size_t)len);
    } else {
      for (int64_t k = 0; k < len; k++) to[k] = from[k];  // overlapping copy
    }
    out += len;
  }
  return out;
}

}  // namespace

extern "C" int64_t vdqn_lz4_frame_decode(const uint8_t* src, int64_t src_len,
                                         uint8_t* dst, int64_t dst_cap) {
  int64_t i = 0, out = 0;
  while (i < src_len) {
    if (i + 4 > src_len) return -2;
    const uint32_t magic = le32(src + i);
    i += 4;
    if ((magic & 0xFFFFFFF0u) == 0x184D2A50u) {  // skippable frame
      if (i + 4 > src_len) return -2;
      i += 4 + (int64_t)le32(src + i);
      if (i > src_len) return -2;
      continue;
    }
    if (magic != 0x184D2204u) return -1;
    if (i + 3 > src_len) return -2;
    const uint8_t flg = src[i];
    if ((flg >> 6) != 1) return -1;  // version 01
    const bool block_checksum = flg & 0x10;
    const bool content_size = flg & 0x08;
    const bool content_checksum = flg & 0x04;
    if (flg & 0x01) return -5;
    i += 2 + (content_size ? 8 : 0) + 1;  // FLG, BD, content size, HC
    if (i > src_len) return -2;
    while (true) {
      if (i + 4 > src_len) return -2;
      const uint32_t word = le32(src + i);
      i += 4;
      if (word == 0) break;  // EndMark
      const int64_t size = word & 0x7FFFFFFFu;
      if (i + size > src_len) return -2;
      if (word & 0x80000000u) {  // stored uncompressed
        if (out + size > dst_cap) return -3;
        std::memcpy(dst + out, src + i, (size_t)size);
        out += size;
      } else {
        out = decode_block(src + i, size, dst, out, dst_cap);
        if (out < 0) return out;
      }
      i += size + (block_checksum ? 4 : 0);
    }
    i += content_checksum ? 4 : 0;
    if (i > src_len) return -2;
  }
  return out;
}
