// Baseline JPEG entropy coding for super_resolution_tpu_torch.
//
// The serial half of the port's JPEG writer (utils/jpeg.py encode_jpeg): the
// Huffman coding of quantised DCT blocks into one scan's entropy-coded data,
// as libjpeg-turbo's jchuff.c (encode_one_block) codes them: per block the DC
// difference from the component's previous block, then the AC run-lengths in
// zigzag order with ZRL (0xF0) for runs past 15 and EOB (0x00) after the last
// non-zero coefficient; 0xFF bytes stuffed with 0x00; the last byte padded
// with one bits. Colour conversion, downsampling, the forward DCT,
// quantisation and the markers are numpy / Python in utils/jpeg.py.
//
// Build: g++ -O3 -shared -fPIC -std=c++17 jpeg_encoder.cpp -o <lib>.so
// (native/__init__.py does this at first use, into
// super_resolution_tpu_torch/_build/).

#include <cstdint>

namespace {

struct BitWriter {
  uint8_t* out;
  int64_t capacity;
  int64_t pos = 0;
  uint64_t acc = 0;  // pending bits, right-aligned
  int bits = 0;
  bool overflow = false;

  void Byte(uint8_t b) {
    if (pos + 2 > capacity) {
      overflow = true;
      return;
    }
    out[pos++] = b;
    if (b == 0xFF) out[pos++] = 0x00;
  }
  void Put(uint32_t code, int size) {
    if (size == 0) return;
    acc = (acc << size) | (code & ((1u << size) - 1));
    bits += size;
    while (bits >= 8) {
      bits -= 8;
      Byte(static_cast<uint8_t>(acc >> bits));
    }
  }
  void Flush() { Put(0x7F, (8 - bits) & 7); }
};

inline int BitLength(int v) {
  int n = 0;
  while (v) {
    ++n;
    v >>= 1;
  }
  return n;
}

}  // namespace

extern "C" {

// Codes `num_blocks` blocks of 64 int16 coefficients each, in zigzag order
// and in the order of the scan (MCU by MCU), into `out` (`capacity` bytes).
// `component[b]` is block b's component (0-3); its Huffman codes are
// dc_code / dc_size [component * 16 + symbol] and ac_code / ac_size
// [component * 256 + symbol] (size 0: the symbol has no code). Returns the
// bytes written, -1 when `out` is too small, -2 for a coefficient or symbol
// that the tables cannot code.
int64_t sr_jpeg_encode_scan(const int16_t* blocks, const uint8_t* component, int64_t num_blocks,
                            const uint16_t* dc_code, const uint8_t* dc_size, const uint16_t* ac_code,
                            const uint8_t* ac_size, uint8_t* out, int64_t capacity) {
  BitWriter w{out, capacity};
  int last_dc[4] = {0, 0, 0, 0};
  for (int64_t b = 0; b < num_blocks && !w.overflow; ++b) {
    const int16_t* blk = blocks + b * 64;
    const int c = component[b] & 3;
    int diff = blk[0] - last_dc[c];
    last_dc[c] = blk[0];
    int bits = diff;
    if (diff < 0) {
      diff = -diff;
      --bits;
    }
    int nbits = BitLength(diff);
    if (nbits > 11 || dc_size[c * 16 + nbits] == 0) return -2;
    w.Put(dc_code[c * 16 + nbits], dc_size[c * 16 + nbits]);
    w.Put(static_cast<uint32_t>(bits), nbits);
    int run = 0;
    for (int k = 1; k < 64; ++k) {
      int v = blk[k];
      if (v == 0) {
        ++run;
        continue;
      }
      while (run > 15) {
        if (ac_size[c * 256 + 0xF0] == 0) return -2;
        w.Put(ac_code[c * 256 + 0xF0], ac_size[c * 256 + 0xF0]);
        run -= 16;
      }
      bits = v;
      if (v < 0) {
        v = -v;
        --bits;
      }
      nbits = BitLength(v);
      const int symbol = (run << 4) + nbits;
      if (nbits > 10 || ac_size[c * 256 + symbol] == 0) return -2;
      w.Put(ac_code[c * 256 + symbol], ac_size[c * 256 + symbol]);
      w.Put(static_cast<uint32_t>(bits), nbits);
      run = 0;
    }
    if (run > 0) {
      if (ac_size[c * 256] == 0) return -2;
      w.Put(ac_code[c * 256], ac_size[c * 256]);
    }
  }
  w.Flush();
  return w.overflow ? -1 : w.pos;
}

}  // extern "C"
