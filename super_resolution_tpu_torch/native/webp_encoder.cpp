// VP8L (WebP lossless) encoding for super_resolution_tpu_torch's codec
// (utils/webp.py): the serial half, bound with ctypes.
//
// A simple encoder: the subtract-green transform, then the predictor
// transform with the mode of each 32x32 block chosen by the least sum of
// absolute residuals, then LZ77 with a hash chain (matches of 3 to 4096
// pixels; a distance that is one of the 120 short 2D codes is sent as that
// code), no colour cache, and one group of five canonical prefix codes
// (lengths at most 15; their code-length code at most 7). Any valid VP8L
// stream of the same pixels decodes to the same image, so the parity asked
// of it is of pixels, not of libwebp's bytes.
//
// Build: g++ -O3 -shared -fPIC -std=c++17 webp_encoder.cpp -o <lib>.so
// (native/__init__.py does this at first use, into
// super_resolution_tpu_torch/_build/).

#include <algorithm>
#include <cstdint>
#include <cstdlib>
#include <functional>
#include <queue>
#include <utility>
#include <vector>

namespace {

class BitWriter {
 public:
  BitWriter(uint8_t* out, int64_t capacity) : out_(out), capacity_(capacity) {}
  void Write(uint32_t value, int n) {
    bits_ |= static_cast<uint64_t>(value) << count_;
    count_ += n;
    while (count_ >= 8) {
      if (pos_ < capacity_) out_[pos_] = static_cast<uint8_t>(bits_);
      ++pos_;
      bits_ >>= 8;
      count_ -= 8;
    }
  }
  // Bytes written, the last one padded with zero bits; -1 if they did not fit.
  int64_t Finish() {
    if (count_ > 0) Write(0, 8 - count_);
    return pos_ <= capacity_ ? pos_ : -1;
  }

 private:
  uint8_t* out_;
  int64_t capacity_;
  int64_t pos_ = 0;
  uint64_t bits_ = 0;
  int count_ = 0;
};

// Code lengths of a Huffman code for `counts`, none longer than `limit`:
// counts are halved (staying >= 1) until the tree is shallow enough. One
// used symbol gets length 1 (a reader takes it as a code of no bits).
std::vector<int> CodeLengths(std::vector<uint64_t> counts, int limit) {
  const int n = static_cast<int>(counts.size());
  std::vector<int> lengths(n, 0);
  std::vector<int> used;
  for (int s = 0; s < n; ++s) {
    if (counts[s] > 0) used.push_back(s);
  }
  if (used.size() <= 2) {
    for (int s : used) lengths[s] = 1;
    return lengths;
  }
  while (true) {
    using Node = std::pair<uint64_t, int>;  // (weight, node id)
    std::priority_queue<Node, std::vector<Node>, std::greater<Node>> heap;
    std::vector<int> parent(2 * used.size(), -1);
    for (size_t i = 0; i < used.size(); ++i) heap.push({counts[used[i]], static_cast<int>(i)});
    int next = static_cast<int>(used.size());
    while (heap.size() > 1) {
      const Node a = heap.top();
      heap.pop();
      const Node b = heap.top();
      heap.pop();
      parent[a.second] = parent[b.second] = next;
      heap.push({a.first + b.first, next++});
    }
    int deepest = 0;
    for (size_t i = 0; i < used.size(); ++i) {
      int depth = 0;
      for (int node = static_cast<int>(i); parent[node] >= 0; node = parent[node]) ++depth;
      lengths[used[i]] = depth;
      deepest = std::max(deepest, depth);
    }
    if (deepest <= limit) return lengths;
    for (int s : used) counts[s] = (counts[s] + 1) / 2;
  }
}

// Canonical codes for `lengths`, bit-reversed for a least-significant-bit-first writer.
std::vector<uint32_t> ReversedCodes(const std::vector<int>& lengths) {
  std::vector<uint32_t> codes(lengths.size(), 0);
  uint32_t code = 0;
  for (int len = 1; len <= 15; ++len) {
    for (size_t s = 0; s < lengths.size(); ++s) {
      if (lengths[s] != len) continue;
      uint32_t reversed = 0;
      for (int b = 0; b < len; ++b) reversed |= ((code >> b) & 1) << (len - 1 - b);
      codes[s] = reversed;
      ++code;
    }
    code <<= 1;
  }
  return codes;
}

struct PrefixCode {
  std::vector<int> lengths;
  std::vector<uint32_t> codes;
  bool single = false;  // one used symbol: written with no bits

  explicit PrefixCode(const std::vector<uint64_t>& counts, int limit) : lengths(CodeLengths(counts, limit)) {
    codes = ReversedCodes(lengths);
    single = std::count_if(lengths.begin(), lengths.end(), [](int l) { return l > 0; }) == 1;
  }
  void Put(BitWriter& bw, int symbol) const {
    if (!single) bw.Write(codes[symbol], lengths[symbol]);
  }
};

constexpr int kCodeLengthOrder[19] = {17, 18, 0, 1, 2, 3, 4, 5, 16, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15};

// Writes a prefix code's lengths as the bitstream's "normal" code: the
// lengths run-length coded (17 / 18 for runs of zeros) with a code-length
// code of its own. An unused alphabet is written as a one-symbol "simple" code.
void WriteCode(BitWriter& bw, const PrefixCode& code) {
  const std::vector<int>& lengths = code.lengths;
  if (std::all_of(lengths.begin(), lengths.end(), [](int l) { return l == 0; })) {
    bw.Write(1, 1);  // simple
    bw.Write(0, 1);  // one symbol
    bw.Write(0, 1);  // of one bit
    bw.Write(0, 1);  // symbol 0
    return;
  }
  std::vector<std::pair<int, int>> tokens;  // (code-length symbol, extra bits value)
  const int n = static_cast<int>(lengths.size());
  for (int i = 0; i < n;) {
    if (lengths[i] != 0) {
      tokens.push_back({lengths[i], 0});
      ++i;
      continue;
    }
    int run = 0;
    while (i + run < n && lengths[i + run] == 0) ++run;
    i += run;
    while (run > 0) {
      if (run >= 11) {
        const int r = std::min(run, 138);
        tokens.push_back({18, r - 11});
        run -= r;
      } else if (run >= 3) {
        tokens.push_back({17, run - 3});
        run = 0;
      } else {
        tokens.push_back({0, 0});
        --run;
      }
    }
  }
  std::vector<uint64_t> counts(19, 0);
  for (const auto& t : tokens) ++counts[t.first];
  const PrefixCode cl_code(counts, 7);
  int written = 19;
  while (written > 4 && cl_code.lengths[kCodeLengthOrder[written - 1]] == 0) --written;
  bw.Write(0, 1);  // normal
  bw.Write(static_cast<uint32_t>(written - 4), 4);
  for (int i = 0; i < written; ++i) bw.Write(static_cast<uint32_t>(cl_code.lengths[kCodeLengthOrder[i]]), 3);
  bw.Write(0, 1);  // the lengths cover the whole alphabet
  for (const auto& t : tokens) {
    cl_code.Put(bw, t.first);
    if (t.first == 17) bw.Write(static_cast<uint32_t>(t.second), 3);
    if (t.first == 18) bw.Write(static_cast<uint32_t>(t.second), 7);
  }
}

// A length or distance value (>= 1) as (prefix symbol, extra bits, their count).
void PrefixEncode(int value, int& symbol, int& extra, int& extra_bits) {
  const int v = value - 1;
  if (v < 4) {
    symbol = v;
    extra = extra_bits = 0;
    return;
  }
  int high = 31 - __builtin_clz(static_cast<unsigned>(v));
  const int second = (v >> (high - 1)) & 1;
  extra_bits = high - 1;
  extra = v & ((1 << extra_bits) - 1);
  symbol = 2 * high + second;
}

// One symbol of the coded image: a literal pixel or a backward reference.
struct Token {
  uint32_t argb;
  int length;  // 0: literal
  int dist_code;
};

// Histograms, codes and the data of an entropy-coded image (one group).
void WriteImageData(BitWriter& bw, const std::vector<Token>& tokens) {
  std::vector<uint64_t> counts[5] = {std::vector<uint64_t>(256 + 24, 0), std::vector<uint64_t>(256, 0),
                                     std::vector<uint64_t>(256, 0), std::vector<uint64_t>(256, 0),
                                     std::vector<uint64_t>(40, 0)};
  int sym, extra, bits;
  for (const Token& t : tokens) {
    if (t.length == 0) {
      ++counts[0][(t.argb >> 8) & 0xff];
      ++counts[1][(t.argb >> 16) & 0xff];
      ++counts[2][t.argb & 0xff];
      ++counts[3][t.argb >> 24];
    } else {
      PrefixEncode(t.length, sym, extra, bits);
      ++counts[0][256 + sym];
      PrefixEncode(t.dist_code, sym, extra, bits);
      ++counts[4][sym];
    }
  }
  std::vector<PrefixCode> codes;
  for (const auto& c : counts) codes.emplace_back(c, 15);
  for (const PrefixCode& code : codes) WriteCode(bw, code);
  for (const Token& t : tokens) {
    if (t.length == 0) {
      codes[0].Put(bw, (t.argb >> 8) & 0xff);
      codes[1].Put(bw, (t.argb >> 16) & 0xff);
      codes[2].Put(bw, t.argb & 0xff);
      codes[3].Put(bw, t.argb >> 24);
    } else {
      PrefixEncode(t.length, sym, extra, bits);
      codes[0].Put(bw, 256 + sym);
      bw.Write(static_cast<uint32_t>(extra), bits);
      PrefixEncode(t.dist_code, sym, extra, bits);
      codes[4].Put(bw, sym);
      bw.Write(static_cast<uint32_t>(extra), bits);
    }
  }
}

// (row << 4) | (8 - column) of distance codes 1 to 120.
constexpr uint8_t kCodeToPlane[120] = {
    0x18, 0x07, 0x17, 0x19, 0x28, 0x06, 0x27, 0x29, 0x16, 0x1a, 0x26, 0x2a, 0x38, 0x05, 0x37, 0x39,
    0x15, 0x1b, 0x36, 0x3a, 0x25, 0x2b, 0x48, 0x04, 0x47, 0x49, 0x14, 0x1c, 0x35, 0x3b, 0x46, 0x4a,
    0x24, 0x2c, 0x58, 0x45, 0x4b, 0x34, 0x3c, 0x03, 0x57, 0x59, 0x13, 0x1d, 0x56, 0x5a, 0x23, 0x2d,
    0x44, 0x4c, 0x55, 0x5b, 0x33, 0x3d, 0x68, 0x02, 0x67, 0x69, 0x12, 0x1e, 0x66, 0x6a, 0x22, 0x2e,
    0x54, 0x5c, 0x43, 0x4d, 0x65, 0x6b, 0x32, 0x3e, 0x78, 0x01, 0x77, 0x79, 0x53, 0x5d, 0x11, 0x1f,
    0x64, 0x6c, 0x42, 0x4e, 0x76, 0x7a, 0x21, 0x2f, 0x75, 0x7b, 0x31, 0x3f, 0x63, 0x6d, 0x52, 0x5e,
    0x00, 0x74, 0x7c, 0x41, 0x4f, 0x10, 0x20, 0x62, 0x6e, 0x30, 0x73, 0x7d, 0x51, 0x5f, 0x40, 0x72,
    0x7e, 0x61, 0x6f, 0x50, 0x71, 0x7f, 0x60, 0x70};

constexpr int kMinMatch = 3;
constexpr int kMaxMatch = 4096;
constexpr int kMaxDistance = (1 << 20) - 121;
constexpr int kChainDepth = 24;
constexpr int kHashBits = 18;

// LZ77 over the pixels with a hash chain on runs of three.
std::vector<Token> Backrefs(const std::vector<uint32_t>& px, int xsize) {
  const int n = static_cast<int>(px.size());
  // The smallest distance code of each short distance.
  const int short_span = 8 * xsize + 8;
  std::vector<int> short_code(short_span + 1, 0);
  for (int code = 120; code >= 1; --code) {
    const int c = kCodeToPlane[code - 1];
    const int dist = std::max(1, (c >> 4) * xsize + (8 - (c & 15)));
    if (dist <= short_span) short_code[dist] = code;
  }
  std::vector<int> head(1 << kHashBits, -1), prev(n, -1);
  auto hash = [&](int i) {
    const uint64_t h = (px[i] * 0x9E3779B1ull) ^ (px[i + 1] * 0x85EBCA77ull) ^ (px[i + 2] * 0xC2B2AE3Dull);
    return static_cast<int>((h * 0x9E3779B97F4A7C15ull) >> (64 - kHashBits));
  };
  auto insert = [&](int i) {
    if (i + kMinMatch > n) return;
    const int h = hash(i);
    prev[i] = head[h];
    head[h] = i;
  };
  auto match_length = [&](int i, int j) {
    const int limit = std::min(kMaxMatch, n - i);
    int len = 0;
    while (len < limit && px[i + len] == px[j + len]) ++len;
    return len;
  };
  std::vector<Token> tokens;
  tokens.reserve(n);
  for (int i = 0; i < n;) {
    int best_len = 0, best_dist = 0;
    if (i + kMinMatch <= n) {
      for (int dist : {1, xsize}) {  // the pixel to the left and the one above
        if (dist <= i) {
          const int len = match_length(i, i - dist);
          if (len > best_len) best_len = len, best_dist = dist;
        }
      }
      int depth = 0;
      for (int j = head[hash(i)]; j >= 0 && depth < kChainDepth && best_len < kMaxMatch; j = prev[j], ++depth) {
        if (i - j > kMaxDistance) break;
        const int len = match_length(i, j);
        if (len > best_len) best_len = len, best_dist = i - j;
      }
    }
    if (best_len >= kMinMatch) {
      const int code = best_dist <= short_span && short_code[best_dist] ? short_code[best_dist] : best_dist + 120;
      tokens.push_back({0, best_len, code});
      for (int k = 0; k < best_len; ++k) insert(i + k);
      i += best_len;
    } else {
      tokens.push_back({px[i], 0, 0});
      insert(i);
      ++i;
    }
  }
  return tokens;
}

inline uint32_t SubPixels(uint32_t a, uint32_t b) {
  const uint32_t ag = 0x00ff00ffu + (a & 0xff00ff00u) - (b & 0xff00ff00u);
  const uint32_t rb = 0xff00ff00u + (a & 0x00ff00ffu) - (b & 0x00ff00ffu);
  return (ag & 0xff00ff00u) | (rb & 0x00ff00ffu);
}
inline uint32_t Average2(uint32_t a, uint32_t b) { return (((a ^ b) & 0xfefefefeu) >> 1) + (a & b); }
inline int Channel(uint32_t v, int shift) { return static_cast<int>((v >> shift) & 0xff); }
inline uint32_t Clip255(int v) { return static_cast<uint32_t>(v < 0 ? 0 : v > 255 ? 255 : v); }

uint32_t Predict(int mode, uint32_t left, uint32_t top, uint32_t top_right, uint32_t top_left) {
  switch (mode) {
    case 1: return left;
    case 2: return top;
    case 3: return top_right;
    case 4: return top_left;
    case 5: return Average2(Average2(left, top_right), top);
    case 6: return Average2(left, top_left);
    case 7: return Average2(left, top);
    case 8: return Average2(top_left, top);
    case 9: return Average2(top, top_right);
    case 10: return Average2(Average2(left, top_left), Average2(top, top_right));
    case 11: {
      int pa_minus_pb = 0;
      for (int shift = 0; shift < 32; shift += 8) {
        const int c = Channel(top_left, shift);
        pa_minus_pb += std::abs(Channel(left, shift) - c) - std::abs(Channel(top, shift) - c);
      }
      return pa_minus_pb <= 0 ? top : left;
    }
    case 12: {
      uint32_t out = 0;
      for (int shift = 0; shift < 32; shift += 8) {
        out |= Clip255(Channel(left, shift) + Channel(top, shift) - Channel(top_left, shift)) << shift;
      }
      return out;
    }
    case 13: {
      const uint32_t avg = Average2(left, top);
      uint32_t out = 0;
      for (int shift = 0; shift < 32; shift += 8) {
        const int x = Channel(avg, shift);
        out |= Clip255(x + (x - Channel(top_left, shift)) / 2) << shift;
      }
      return out;
    }
    default: return 0xff000000u;
  }
}

constexpr int kPredictorBits = 5;

// The predictor transform: each block's mode (in the green channel of the
// returned sub-image) and `px` replaced by its residuals.
std::vector<uint32_t> PredictorTransform(std::vector<uint32_t>& px, int w, int h) {
  const int bw = (w + (1 << kPredictorBits) - 1) >> kPredictorBits;
  const int bh = (h + (1 << kPredictorBits) - 1) >> kPredictorBits;
  std::vector<uint32_t> modes(static_cast<size_t>(bw) * bh);
  auto residual_cost = [](uint32_t r) {
    int cost = 0;
    for (int shift = 0; shift < 32; shift += 8) cost += std::abs(static_cast<int8_t>((r >> shift) & 0xff));
    return cost;
  };
  for (int by = 0; by < bh; ++by) {
    for (int bx = 0; bx < bw; ++bx) {
      const int x0 = bx << kPredictorBits, y0 = by << kPredictorBits;
      const int x1 = std::min(w, x0 + (1 << kPredictorBits)), y1 = std::min(h, y0 + (1 << kPredictorBits));
      int best_mode = 1;
      int64_t best_cost = -1;
      for (int mode = 0; mode < 14; ++mode) {
        int64_t cost = 0;
        for (int y = std::max(y0, 1); y < y1; ++y) {
          for (int x = std::max(x0, 1); x < x1; ++x) {
            const int64_t i = static_cast<int64_t>(y) * w + x;
            cost += residual_cost(SubPixels(px[i], Predict(mode, px[i - 1], px[i - w], px[i - w + 1], px[i - w - 1])));
          }
        }
        if (best_cost < 0 || cost < best_cost) best_cost = cost, best_mode = mode;
      }
      modes[static_cast<size_t>(by) * bw + bx] = 0xff000000u | static_cast<uint32_t>(best_mode) << 8;
    }
  }
  std::vector<uint32_t> residuals(px.size());
  for (int y = 0; y < h; ++y) {
    for (int x = 0; x < w; ++x) {
      const int64_t i = static_cast<int64_t>(y) * w + x;
      uint32_t pred;
      if (y == 0) {
        pred = x == 0 ? 0xff000000u : px[i - 1];
      } else if (x == 0) {
        pred = px[i - w];
      } else {
        const int mode = static_cast<int>((modes[(y >> kPredictorBits) * bw + (x >> kPredictorBits)] >> 8) & 15);
        pred = Predict(mode, px[i - 1], px[i - w], px[i - w + 1], px[i - w - 1]);
      }
      residuals[i] = SubPixels(px[i], pred);
    }
  }
  px.swap(residuals);
  return modes;
}

}  // namespace

extern "C" {

// Encodes `width` x `height` ARGB pixels as a VP8L bitstream (its 5-byte
// header included) into `out` (`capacity` bytes). Returns the bytes
// written, or -1 when they do not fit.
int64_t sr_vp8l_encode(const uint32_t* argb, int width, int height, uint8_t* out, int64_t capacity) {
  std::vector<uint32_t> px(argb, argb + static_cast<int64_t>(width) * height);
  const bool alpha = std::any_of(px.begin(), px.end(), [](uint32_t p) { return (p >> 24) != 0xff; });
  BitWriter bw(out, capacity);
  bw.Write(0x2f, 8);
  bw.Write(static_cast<uint32_t>(width - 1), 14);
  bw.Write(static_cast<uint32_t>(height - 1), 14);
  bw.Write(alpha ? 1 : 0, 1);
  bw.Write(0, 3);  // version
  for (uint32_t& p : px) {  // subtract green
    const uint32_t green = (p >> 8) & 0xff;
    p = (p & 0xff00ff00u) | ((((p >> 16) - green) & 0xff) << 16) | ((p - green) & 0xff);
  }
  bw.Write(1, 1);
  bw.Write(2, 2);
  const std::vector<uint32_t> modes = PredictorTransform(px, width, height);
  bw.Write(1, 1);
  bw.Write(0, 2);
  bw.Write(kPredictorBits - 2, 3);
  bw.Write(0, 1);  // the mode image: no colour cache
  std::vector<Token> mode_tokens;
  for (uint32_t m : modes) mode_tokens.push_back({m, 0, 0});
  WriteImageData(bw, mode_tokens);
  bw.Write(0, 1);  // no more transforms
  bw.Write(0, 1);  // no colour cache
  bw.Write(0, 1);  // no meta prefix codes
  WriteImageData(bw, Backrefs(px, width));
  return bw.Finish();
}

}  // extern "C"
