// JPEG 2000 pieces shared by native/jpeg2000_decoder.cpp and
// native/jpeg2000_encoder.cpp: the tag trees of packet headers (T.800 B.10.2,
// as opj_tgt codes them), the MQ coder's probability states (T.800 Table
// C.2), the context numbers as OpenJPEG numbers them, the neighbour flags of
// one coefficient and the zero-coding and sign-coding context tables built
// from them (T.800 Tables D.1 to D.3).

#ifndef SR_JPEG2000_TABLES_H_
#define SR_JPEG2000_TABLES_H_

#include <algorithm>
#include <cstdint>
#include <utility>
#include <vector>

namespace {

// A tag tree over w x h leaves; `Bits` reads (Bit()) or writes (Bit(b)) the
// packet header's bits.
struct TagTree {
  struct Node {
    int parent, value, low;
    bool known;  // the encoder has sent that the value is reached
  };
  std::vector<Node> nodes;

  void Build(int w, int h) {
    nodes.clear();
    if (w <= 0 || h <= 0) return;
    std::vector<int> ws{w}, hs{h};
    while (ws.back() > 1 || hs.back() > 1) {
      ws.push_back((ws.back() + 1) / 2);
      hs.push_back((hs.back() + 1) / 2);
    }
    std::vector<int> offset(ws.size());
    int total = 0;
    for (size_t l = 0; l < ws.size(); ++l) {
      offset[l] = total;
      total += ws[l] * hs[l];
    }
    nodes.assign(size_t(total), Node{-1, 999, 0, false});
    for (size_t l = 0; l + 1 < ws.size(); ++l)
      for (int y = 0; y < hs[l]; ++y)
        for (int x = 0; x < ws[l]; ++x)
          nodes[size_t(offset[l] + y * ws[l] + x)].parent = offset[l + 1] + (y / 2) * ws[l + 1] + x / 2;
  }

  // opj_tgt_reset
  void Reset() {
    for (Node& n : nodes) n = Node{n.parent, 999, 0, false};
  }

  // opj_tgt_setvalue: the leaf's value, and its ancestors' down to it.
  void SetValue(int leaf, int value) {
    for (int n = leaf; n >= 0 && nodes[size_t(n)].value > value; n = nodes[size_t(n)].parent)
      nodes[size_t(n)].value = value;
  }

  // opj_tgt_decode: whether the leaf's value is below `threshold`.
  template <typename Bits>
  bool Decode(Bits& bio, int leaf, int threshold) {
    int depth = 0, node = leaf;
    int stack[40];
    while (nodes[size_t(node)].parent >= 0) {
      stack[depth++] = node;
      node = nodes[size_t(node)].parent;
    }
    int low = 0;
    for (;;) {
      Node& n = nodes[size_t(node)];
      if (low > n.low) {
        n.low = low;
      } else {
        low = n.low;
      }
      while (low < threshold && low < n.value) {
        if (bio.Bit()) {
          n.value = low;
        } else {
          ++low;
        }
      }
      n.low = low;
      if (depth == 0) break;
      node = stack[--depth];
    }
    return nodes[size_t(node)].value < threshold;
  }

  // opj_tgt_encode: the bits that tell a decoder whether the leaf's value is
  // below `threshold`.
  template <typename Bits>
  void Encode(Bits& bio, int leaf, int threshold) {
    int depth = 0, node = leaf;
    int stack[40];
    while (nodes[size_t(node)].parent >= 0) {
      stack[depth++] = node;
      node = nodes[size_t(node)].parent;
    }
    int low = 0;
    for (;;) {
      Node& n = nodes[size_t(node)];
      if (low > n.low) {
        n.low = low;
      } else {
        low = n.low;
      }
      while (low < threshold) {
        if (low >= n.value) {
          if (!n.known) {
            bio.Bit(1);
            n.known = true;
          }
          break;
        }
        bio.Bit(0);
        ++low;
      }
      n.low = low;
      if (depth == 0) break;
      node = stack[--depth];
    }
  }
};

struct MqState {
  uint16_t qe;
  uint8_t nmps, nlps, sw;
};

const MqState kMq[47] = {
    {0x5601, 1, 1, 1},   {0x3401, 2, 6, 0},   {0x1801, 3, 9, 0},   {0x0AC1, 4, 12, 0},  {0x0521, 5, 29, 0},
    {0x0221, 38, 33, 0}, {0x5601, 7, 6, 1},   {0x5401, 8, 14, 0},  {0x4801, 9, 14, 0},  {0x3801, 10, 14, 0},
    {0x3001, 11, 17, 0}, {0x2401, 12, 18, 0}, {0x1C01, 13, 20, 0}, {0x1601, 29, 21, 0}, {0x5601, 15, 14, 1},
    {0x5401, 16, 14, 0}, {0x5101, 17, 15, 0}, {0x4801, 18, 16, 0}, {0x3801, 19, 17, 0}, {0x3401, 20, 18, 0},
    {0x3001, 21, 19, 0}, {0x2801, 22, 19, 0}, {0x2401, 23, 20, 0}, {0x2201, 24, 21, 0}, {0x1C01, 25, 22, 0},
    {0x1801, 26, 23, 0}, {0x1601, 27, 24, 0}, {0x1401, 28, 25, 0}, {0x1201, 29, 26, 0}, {0x1101, 30, 27, 0},
    {0x0AC1, 31, 28, 0}, {0x09C1, 32, 29, 0}, {0x08A1, 33, 30, 0}, {0x0521, 34, 31, 0}, {0x0441, 35, 32, 0},
    {0x02A1, 36, 33, 0}, {0x0221, 37, 34, 0}, {0x0141, 38, 35, 0}, {0x0111, 39, 36, 0}, {0x0085, 40, 37, 0},
    {0x0049, 41, 38, 0}, {0x0025, 42, 39, 0}, {0x0015, 43, 40, 0}, {0x0009, 44, 41, 0}, {0x0005, 45, 42, 0},
    {0x0001, 45, 43, 0}, {0x5601, 46, 46, 0}};

enum Context { kCtxZc = 0, kCtxSc = 9, kCtxMag = 14, kCtxRl = 17, kCtxUni = 18, kNumCtx = 19 };

// Flags of one coefficient: the significance of its eight neighbours, its own
// state, and the signs of its four direct neighbours.
enum : uint32_t {
  kNw = 1, kN = 2, kNe = 4, kW = 8, kE = 16, kSw = 32, kS = 64, kSe = 128, kNeighbours = 255,
  kSig = 1 << 8, kVisit = 1 << 9, kRefined = 1 << 10,
  kNNeg = 1 << 12, kWNeg = 1 << 13, kENeg = 1 << 14, kSNeg = 1 << 15
};

struct T1Tables {
  uint8_t zc[4][256];
  uint8_t sc[256];  // index: N sig, N neg, W sig, W neg, E sig, E neg, S sig, S neg (bit 0 up)
  T1Tables() {
    for (int orient = 0; orient < 4; ++orient)
      for (int f = 0; f < 256; ++f) {
        int h = !!(f & kW) + !!(f & kE);
        int v = !!(f & kN) + !!(f & kS);
        int d = !!(f & kNw) + !!(f & kNe) + !!(f & kSw) + !!(f & kSe);
        int n = 0;
        if (orient == 1) std::swap(h, v);  // HL: horizontally high-pass
        if (orient < 3) {
          if (h == 0) {
            n = v == 0 ? (d == 0 ? 0 : d == 1 ? 1 : 2) : v == 1 ? 3 : 4;
          } else if (h == 1) {
            n = v == 0 ? (d == 0 ? 5 : 6) : 7;
          } else {
            n = 8;
          }
        } else {
          int hv = h + v;
          if (d == 0) {
            n = hv == 0 ? 0 : hv == 1 ? 1 : 2;
          } else if (d == 1) {
            n = hv == 0 ? 3 : hv == 1 ? 4 : 5;
          } else if (d == 2) {
            n = hv == 0 ? 6 : 7;
          } else {
            n = 8;
          }
        }
        zc[orient][f] = uint8_t(kCtxZc + n);
      }
    for (int f = 0; f < 256; ++f) {
      auto contribution = [&](int sig_bit, int neg_bit) {
        return (f >> sig_bit & 1) ? ((f >> neg_bit & 1) ? -1 : 1) : 0;
      };
      int v = contribution(0, 1) + contribution(6, 7);
      int h = contribution(2, 3) + contribution(4, 5);
      h = std::clamp(h, -1, 1);
      v = std::clamp(v, -1, 1);
      int ctx, x = 0;
      if (h == 0 && v == 0) {
        ctx = 9;
      } else if (h == 0) {
        ctx = 10;
        x = v < 0;
      } else {
        ctx = h * v > 0 ? 13 : h * v < 0 ? 11 : 12;
        x = h < 0;
      }
      sc[f] = uint8_t((ctx << 1) | x);
    }
  }
};

const T1Tables& Tables() {
  static const T1Tables t;
  return t;
}

// Marks the coefficient at `f` (in a flags plane `fw` wide with a border of
// one) significant, with its sign, in its own and its eight neighbours' flags.
inline void MarkSignificant(uint32_t* f, int fw, bool neg) {
  *f |= kSig;
  f[-fw - 1] |= kSe;
  f[-fw] |= kS | (neg ? uint32_t(kSNeg) : 0u);
  f[-fw + 1] |= kSw;
  f[-1] |= kE | (neg ? uint32_t(kENeg) : 0u);
  f[1] |= kW | (neg ? uint32_t(kWNeg) : 0u);
  f[fw - 1] |= kNe;
  f[fw] |= kN | (neg ? uint32_t(kNNeg) : 0u);
  f[fw + 1] |= kNw;
}

// The index of T1Tables::sc for a coefficient's flags.
inline int SignContextIndex(uint32_t f) {
  return int(!!(f & kN)) | int(!!(f & kNNeg)) << 1 | int(!!(f & kW)) << 2 | int(!!(f & kWNeg)) << 3 |
         int(!!(f & kE)) << 4 | int(!!(f & kENeg)) << 5 | int(!!(f & kS)) << 6 | int(!!(f & kSNeg)) << 7;
}

}  // namespace

#endif  // SR_JPEG2000_TABLES_H_
