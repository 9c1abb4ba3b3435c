// LZW for super_resolution_tpu_torch's TIFF and GIF codecs (utils/tiff.py,
// utils/gif.py): the serial half, bound with ctypes.
//
// - TIFF (compression 5): codes of 9 to 12 bits, most significant bit first,
//   CLEAR 256, EOI 257, the code width growing one code early ("early
//   change"), as libtiff's tif_lzw.c. The encoder is libtiff's: the same
//   open-addressed hash (9001 slots), the table reset at 4094 entries, and
//   the compression-ratio check every 10000 input bytes that resets it when
//   the ratio stops rising; so its output is libtiff's, byte for byte.
// - GIF: codes of (minimum code size + 1) to 12 bits, least significant bit
//   first, the clear and end codes after the colour indices, the width
//   growing when the table reaches its size; a full table stays in use until
//   the next clear code (a "deferred clear").
//
// Build: g++ -O3 -shared -fPIC -std=c++17 lzw.cpp -o <lib>.so
// (native/__init__.py does this at first use, into
// super_resolution_tpu_torch/_build/).

#include <cstdint>
#include <cstring>
#include <vector>

namespace {

constexpr int kMaxBits = 12;
constexpr int kTableSize = 1 << kMaxBits;

// A string table: each entry is its prefix's entry plus one byte.
struct Table {
  int32_t prefix[kTableSize];
  uint8_t suffix[kTableSize];
  uint8_t first[kTableSize];
  int32_t length[kTableSize];

  void Reset(int literals) {
    for (int i = 0; i < literals; ++i) {
      prefix[i] = -1;
      suffix[i] = first[i] = static_cast<uint8_t>(i);
      length[i] = 1;
    }
  }
  // Writes entry `code`'s string at out[pos..]; at most `room` bytes of it.
  int64_t Emit(int code, uint8_t* out, int64_t pos, int64_t room) const {
    const int32_t n = length[code];
    for (int32_t i = n - 1; i >= 0; --i) {
      if (i < room) out[pos + i] = suffix[code];
      code = prefix[code];
    }
    return n < room ? n : room;
  }
};

}  // namespace

extern "C" {

// Decodes one TIFF LZW strip or tile into `out` (`out_size` bytes, the
// strip's size unpacked). Returns the bytes written (less than `out_size`
// when the data ends early), -1 for corrupt data, -2 for the old-style
// (pre-TIFF 6.0, least significant bit first) LZW that libtiff also reads.
int64_t sr_tiff_lzw_decode(const uint8_t* in, int64_t n, uint8_t* out, int64_t out_size) {
  if (n >= 2 && in[0] == 0 && (in[1] & 1)) return -2;
  std::vector<Table> holder(1);
  Table& t = holder[0];
  t.Reset(256);
  int width = 9, next = 258, old = -1;
  uint64_t acc = 0;
  int bits = 0;
  int64_t pos = 0, written = 0;
  while (written < out_size) {
    while (bits < width && pos < n) {
      acc = (acc << 8) | in[pos++];
      bits += 8;
    }
    if (bits < width) break;
    const int code = static_cast<int>((acc >> (bits - width)) & ((1u << width) - 1));
    bits -= width;
    if (code == 257) break;
    if (code == 256) {
      width = 9;
      next = 258;
      old = -1;
      continue;
    }
    if (old < 0) {
      if (code > 255) return -1;
      out[written++] = static_cast<uint8_t>(code);
      old = code;
      continue;
    }
    if (code > next || next >= kTableSize) return -1;
    t.prefix[next] = old;
    t.first[next] = t.first[old];
    t.length[next] = t.length[old] + 1;
    t.suffix[next] = code < next ? t.first[code] : t.first[old];
    ++next;
    if (next + 1 >= (1 << width) && width < kMaxBits) ++width;
    written += t.Emit(code, out, written, out_size - written);
    old = code;
  }
  return written;
}

// Encodes `n` bytes as one TIFF LZW strip, as libtiff's LZWPreEncode /
// LZWEncode / LZWPostEncode do. Returns the bytes written, or -1 when
// `capacity` is too small.
int64_t sr_tiff_lzw_encode(const uint8_t* in, int64_t n, uint8_t* out, int64_t capacity) {
  constexpr int kClear = 256, kEoi = 257, kFirst = 258, kCodeMax = (1 << kMaxBits) - 1;
  constexpr int kHashSize = 9001, kHashShift = 13 - 8, kCheckGap = 10000;
  std::vector<int64_t> hash(kHashSize, -1);
  std::vector<uint16_t> codes(kHashSize, 0);
  int nbits = 9, maxcode = (1 << 9) - 1, free_ent = kFirst;
  uint64_t nextdata = 0;
  int nextbits = 0;
  int64_t op = 0, incount = 0, outcount = 0, checkpoint = kCheckGap, ratio = 0;
  bool overflow = false;
  auto put = [&](int c) {
    if (op + 2 > capacity) {
      overflow = true;
      return;
    }
    nextdata = (nextdata << nbits) | static_cast<uint64_t>(c);
    nextbits += nbits;
    out[op++] = static_cast<uint8_t>(nextdata >> (nextbits - 8));
    nextbits -= 8;
    if (nextbits >= 8) {
      out[op++] = static_cast<uint8_t>(nextdata >> (nextbits - 8));
      nextbits -= 8;
    }
    outcount += nbits;
  };
  auto reset = [&]() {
    std::fill(hash.begin(), hash.end(), -1);
    ratio = 0;
    incount = 0;
    outcount = 0;
    free_ent = kFirst;
    put(kClear);
    nbits = 9;
    maxcode = (1 << 9) - 1;
  };
  int ent = -1;
  int64_t i = 0;
  if (n > 0) {
    put(kClear);
    ent = in[i++];
    ++incount;
  }
  while (i < n && !overflow) {
    const int c = in[i++];
    ++incount;
    const int64_t fcode = (static_cast<int64_t>(c) << kMaxBits) + ent;
    int h = (c << kHashShift) ^ ent;
    if (hash[h] == fcode) {
      ent = codes[h];
      continue;
    }
    bool hit = false;
    if (hash[h] >= 0) {
      // Secondary probe, as libtiff's.
      const int disp = h == 0 ? 1 : kHashSize - h;
      do {
        if ((h -= disp) < 0) h += kHashSize;
        if (hash[h] == fcode) {
          ent = codes[h];
          hit = true;
          break;
        }
      } while (hash[h] >= 0);
    }
    if (hit) continue;
    put(ent);
    ent = c;
    codes[h] = static_cast<uint16_t>(free_ent++);
    hash[h] = fcode;
    if (free_ent == kCodeMax - 1) {
      reset();
    } else if (free_ent > maxcode) {
      ++nbits;
      maxcode = (1 << nbits) - 1;
    } else if (incount >= checkpoint) {
      checkpoint = incount + kCheckGap;
      int64_t rat;
      if (incount > 0x007fffff) {
        rat = outcount >> 8;
        rat = rat == 0 ? 0x7fffffff : incount / rat;
      } else {
        rat = (incount << 8) / outcount;
      }
      if (rat <= ratio) {
        reset();
      } else {
        ratio = rat;
      }
    }
  }
  if (ent >= 0) {
    put(ent);
    ++free_ent;
    if (free_ent == kCodeMax - 1) {
      outcount = 0;
      put(kClear);
      nbits = 9;
    } else if (free_ent > maxcode) {
      ++nbits;
    }
  }
  put(kEoi);
  if (nextbits > 0) {
    if (op + 1 > capacity) return -1;
    out[op++] = static_cast<uint8_t>((nextdata << (8 - nextbits)) & 0xff);
  }
  return overflow ? -1 : op;
}

// Decodes one GIF image's LZW data (its sub-blocks already joined) into
// `out` (`out_size` colour indices). Returns the indices written (less than
// `out_size` when the data ends early) or -1 for corrupt data.
int64_t sr_gif_lzw_decode(const uint8_t* in, int64_t n, int min_code_size, uint8_t* out, int64_t out_size) {
  if (min_code_size < 2 || min_code_size > 8) return -1;
  const int clear = 1 << min_code_size, end = clear + 1;
  std::vector<Table> holder(1);
  Table& t = holder[0];
  t.Reset(clear);
  int width = min_code_size + 1, next = end + 1, old = -1;
  uint64_t acc = 0;
  int bits = 0;
  int64_t pos = 0, written = 0;
  while (written < out_size) {
    while (bits < width && pos < n) {
      acc |= static_cast<uint64_t>(in[pos++]) << bits;
      bits += 8;
    }
    if (bits < width) break;
    const int code = static_cast<int>(acc & ((1u << width) - 1));
    acc >>= width;
    bits -= width;
    if (code == clear) {
      width = min_code_size + 1;
      next = end + 1;
      old = -1;
      continue;
    }
    if (code == end) break;
    if (old < 0) {
      if (code >= clear) return -1;
      out[written++] = static_cast<uint8_t>(code);
      old = code;
      continue;
    }
    if (code > next || (code == next && next >= kTableSize)) return -1;
    if (next < kTableSize) {
      t.prefix[next] = old;
      t.first[next] = t.first[old];
      t.length[next] = t.length[old] + 1;
      t.suffix[next] = code < next ? t.first[code] : t.first[old];
      ++next;
      if (next == (1 << width) && width < kMaxBits) ++width;
    }
    written += t.Emit(code, out, written, out_size - written);
    old = code;
  }
  return written;
}

}  // extern "C"
