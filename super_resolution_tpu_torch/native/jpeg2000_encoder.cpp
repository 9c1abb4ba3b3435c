// JPEG 2000 Part 1 codestream encoder: the serial half of
// super_resolution_tpu_torch/utils/jpeg2000.py (encode_jpeg2000).
//
// Encodes one uint8 image of 1 or 3 components into the codestream that
// OpenJPEG 2.5.3 writes under OpenCV's parameters (cv2.imwrite of a .jp2):
// one tile, 5 decomposition levels of the reversible 5/3 transform, 64x64
// code-blocks, default precincts, LRCP, one quality layer, no MCT, no
// quantisation (2 guard bits), a COM marker naming the library. Step by step,
// as OpenJPEG computes it:
//   * the DC level shift by -128 and the forward 5/3 lifting (opj_dwt_encode:
//     columns, then rows, at every level, in integers);
//   * tier-1 (opj_t1_encode_cblk): the coefficients scaled by 2^6
//     (T1_NMSEDEC_FRACBITS), the significance, refinement and cleanup passes
//     through the MQ coder, one codeword a code-block flushed after the last
//     pass; each pass's rate (the bytes so far plus 3 for an unterminated
//     pass, made non-increasing from the end, one byte less where it would
//     end on 0xFF) and its cumulative distortion decrease (the nmsedec tables
//     and opj_t1_getwmsedec with the 5/3 norms, in doubles);
//   * rate allocation (opj_tcd_rateallocate with cp_disto_alloc): the byte
//     budget from the rate as opj_j2k_update_rates reckons it (headers
//     included, in single precision), a bisection on the slope threshold
//     between the smallest and the largest pass slope, each trial's packets
//     measured by tier-2, and the layer made at the last threshold that fit;
//     a rate of 1 or less keeps every pass;
//   * tier-2 (opj_t2_encode_packet): one packet a resolution and component,
//     headers with the inclusion and zero bit-plane tag trees, the pass-count
//     codes, Lblock increments and bit stuffing; an empty packet is still
//     written with its leading 1 bit;
//   * markers: SOC, SIZ, COD, QCD, COM, SOT, SOD, EOC.
// The JP2 boxes around the codestream are written in Python; their length
// enters the byte budget, as the stream position does in OpenJPEG.
//
// The distortions and the allocation need IEEE doubles without contraction
// into fused multiply-adds, as the library's default flags give on x86-64:
// a changed rounding moves the threshold and so the bytes.

#include <algorithm>
#include <cfloat>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <exception>
#include <vector>

#include "jpeg2000_tables.h"

namespace {

constexpr int kLevels = 5;                 // decomposition levels
constexpr int kResolutions = kLevels + 1;  // resolutions
constexpr int kCodeBlockLog = 6;           // 64x64 code-blocks
constexpr int kFracBits = 6;               // T1_NMSEDEC_FRACBITS
constexpr int kGuardBits = 2;
const char kComment[] = "Created by OpenJPEG version 2.5.3";

// Counts and values kept over one encode, in this order (utils/jpeg2000.ENCODER_STATS).
enum Stat {
  kCodeBlocks, kZeroBlocks, kPasses, kPassesKept, kBlocksCut, kBudget, kIterations, kTrials, kPacketBytes,
  kNumStats
};

// ------------------------------------------------------------------ MQ encoder

// opj_mqc_t in encoding mode: `buf[0]` is the fake byte before the codeword,
// `bp` the index of the byte that may still take a carry.
struct MqEncoder {
  std::vector<uint8_t> buf;
  size_t bp = 0;
  uint32_t a = 0, c = 0;
  int ct = 0;
  uint8_t state[kNumCtx], mps[kNumCtx];

  void Init(size_t capacity) {
    buf.assign(capacity + 2, 0);
    bp = 0;
    a = 0x8000;
    c = 0;
    ct = 12;
    std::memset(state, 0, sizeof(state));
    std::memset(mps, 0, sizeof(mps));
    state[kCtxUni] = 46;
    state[kCtxRl] = 3;
    state[kCtxZc] = 4;
  }
  uint32_t NumBytes() const { return uint32_t(bp - 1); }
  void Put(uint8_t v) {
    if (++bp >= buf.size()) buf.resize(buf.size() * 2);
    buf[bp] = v;
  }
  void ByteOut() {
    if (buf[bp] == 0xFF) {
      Put(uint8_t(c >> 20));
      c &= 0xFFFFF;
      ct = 7;
    } else if ((c & 0x8000000) == 0) {
      Put(uint8_t(c >> 19));
      c &= 0x7FFFF;
      ct = 8;
    } else {
      ++buf[bp];
      if (buf[bp] == 0xFF) {
        c &= 0x7FFFFFF;
        Put(uint8_t(c >> 20));
        c &= 0xFFFFF;
        ct = 7;
      } else {
        Put(uint8_t(c >> 19));
        c &= 0x7FFFF;
        ct = 8;
      }
    }
  }
  void Renorm() {
    do {
      a <<= 1;
      c <<= 1;
      if (--ct == 0) ByteOut();
    } while ((a & 0x8000) == 0);
  }
  void Encode(int cx, int d) {
    const MqState& s = kMq[state[cx]];
    a -= s.qe;
    if (d == mps[cx]) {
      if ((a & 0x8000) == 0) {
        if (a < s.qe) {
          a = s.qe;
        } else {
          c += s.qe;
        }
        state[cx] = s.nmps;
        Renorm();
      } else {
        c += s.qe;
      }
    } else {
      if (a < s.qe) {
        c += s.qe;
      } else {
        a = s.qe;
      }
      if (s.sw) mps[cx] = uint8_t(1 - mps[cx]);
      state[cx] = s.nlps;
      Renorm();
    }
  }
  // opj_mqc_flush (T.800 C.2.9): a final 0xFF is not counted.
  void Flush() {
    const uint32_t tempc = c + a;
    c |= 0xFFFF;
    if (c >= tempc) c -= 0x8000;
    c <<= ct;
    ByteOut();
    c <<= ct;
    ByteOut();
    if (buf[bp] != 0xFF) ++bp;
  }
};

// ------------------------------------------------------------------ distortion

// OpenJPEG's lut_nmsedec_sig / _sig0 / _ref / _ref0 (t1_generate_luts.c):
// the decrease in squared error, in units of 2^-13, when a coefficient's bit
// at the current plane is coded, indexed by the 7 bits from that plane down.
struct NmsedecTables {
  int16_t sig[128], sig0[128], ref[128], ref0[128];
  static int16_t Entry(double value) {
    return int16_t(std::max(0, int(std::floor(value * std::pow(2, kFracBits) + 0.5) / std::pow(2, kFracBits) *
                                   8192.0)));
  }
  NmsedecTables() {
    for (int i = 0; i < 128; ++i) {
      const double t = i / std::pow(2, kFracBits);
      double u = t, v = t - 1.5;
      sig[i] = Entry(u * u - v * v);
      sig0[i] = Entry(u * u);
      u = t - 1.0;
      v = (i & 64) ? t - 1.5 : t - 0.5;
      ref[i] = Entry(u * u - v * v);
      ref0[i] = Entry(u * u);
    }
  }
};

const NmsedecTables& Nmsedec() {
  static const NmsedecTables t;
  return t;
}

// opj_dwt_norms: the 5/3 synthesis norms by orientation and level.
const double kNorms[4][10] = {{1.000, 1.500, 2.750, 5.375, 10.68, 21.34, 42.67, 85.33, 170.7, 341.3},
                              {1.038, 1.592, 2.919, 5.703, 11.33, 22.64, 45.25, 90.48, 180.9},
                              {1.038, 1.592, 2.919, 5.703, 11.33, 22.64, 45.25, 90.48, 180.9},
                              {.7186, .9218, 1.586, 3.043, 6.019, 12.01, 24.00, 47.97, 95.93}};

// opj_t1_getwmsedec for the reversible path: no MCT weight, step size 1.
double WeightedMsedec(int nmsedec, int level, int orient, int bpno) {
  const double w1 = 1.0, stepsize = 1.0;
  const double w2 = kNorms[orient][level];
  double wmsedec = w1 * w2 * stepsize * (1 << bpno);
  wmsedec *= wmsedec * nmsedec / 8192.0;
  return wmsedec;
}

// ------------------------------------------------------------------ tier-1

struct Pass {
  uint32_t rate = 0;         // bytes of the codeword up to this pass's end
  double distortiondec = 0;  // cumulative weighted distortion decrease
};

struct CodeBlock {
  int x0, y0, w, h;  // in the tile component's buffer
  int numbps = 0;
  std::vector<uint8_t> data;
  std::vector<Pass> passes;
  int layer_passes = 0;  // passes in the (one) layer
  uint32_t layer_len = 0;
};

void EncodeCodeBlock(CodeBlock& cb, const int32_t* tile, int stride, int orient, int level,
                     std::vector<uint32_t>& mag, std::vector<uint8_t>& neg, std::vector<uint32_t>& flags,
                     MqEncoder& mq) {
  const int w = cb.w, h = cb.h;
  mag.assign(size_t(w) * h, 0);
  neg.assign(size_t(w) * h, 0);
  int32_t max = 0;
  for (int y = 0; y < h; ++y)
    for (int x = 0; x < w; ++x) {
      const int32_t v = int32_t(uint32_t(tile[size_t(cb.y0 + y) * stride + cb.x0 + x]) << kFracBits);
      const int32_t a = v < 0 ? -v : v;
      max = std::max(max, a);
      mag[size_t(y) * w + x] = uint32_t(a);
      neg[size_t(y) * w + x] = v < 0;
    }
  cb.passes.clear();
  if (max == 0) {
    cb.numbps = 0;
    return;
  }
  int floorlog2 = 0;
  while ((max >> (floorlog2 + 1)) != 0) ++floorlog2;
  cb.numbps = floorlog2 + 1 - kFracBits;  // at least 1: a non-zero magnitude is 64 or more

  const int fw = w + 2;
  flags.assign(size_t(fw) * (h + 2), 0);
  const T1Tables& t = Tables();
  const NmsedecTables& lut = Nmsedec();
  const uint8_t* zc = t.zc[orient];
  auto F = [&](int x, int y) -> uint32_t& { return flags[size_t(y + 1) * fw + x + 1]; };
  int nmsedec = 0;
  int bpno = cb.numbps - 1;
  auto NmsedecSig = [&](uint32_t x) { return bpno > 0 ? lut.sig[(x >> bpno) & 127] : lut.sig0[x & 127]; };
  auto NmsedecRef = [&](uint32_t x) { return bpno > 0 ? lut.ref[(x >> bpno) & 127] : lut.ref0[x & 127]; };
  // Codes the sign of the coefficient at (x, y), which becomes significant.
  auto CodeSignificant = [&](int x, int y) {
    const size_t i = size_t(y) * w + x;
    uint32_t& f = F(x, y);
    const int s = t.sc[SignContextIndex(f)];
    nmsedec += NmsedecSig(mag[i]);
    mq.Encode(s >> 1, neg[i] ^ (s & 1));
    MarkSignificant(&f, fw, neg[i]);
  };

  mq.Init(74 + size_t(w) * h * 4);
  double cumwmsedec = 0.0;
  int passtype = 2;
  while (bpno >= 0) {
    const uint32_t one = uint32_t(1) << (bpno + kFracBits);
    nmsedec = 0;
    if (passtype == 0) {  // significance propagation
      for (int k = 0; k < h; k += 4)
        for (int x = 0; x < w; ++x)
          for (int y = k; y < std::min(k + 4, h); ++y) {
            uint32_t& f = F(x, y);
            if ((f & kSig) || !(f & kNeighbours)) continue;
            const int v = (mag[size_t(y) * w + x] & one) ? 1 : 0;
            mq.Encode(zc[f & kNeighbours], v);
            if (v) CodeSignificant(x, y);
            f |= kVisit;
          }
    } else if (passtype == 1) {  // magnitude refinement
      for (int k = 0; k < h; k += 4)
        for (int x = 0; x < w; ++x)
          for (int y = k; y < std::min(k + 4, h); ++y) {
            uint32_t& f = F(x, y);
            if ((f & (kSig | kVisit)) != kSig) continue;
            const uint32_t m = mag[size_t(y) * w + x];
            nmsedec += NmsedecRef(m);
            const int ctx = (f & kRefined) ? kCtxMag + 2 : (f & kNeighbours) ? kCtxMag + 1 : kCtxMag;
            mq.Encode(ctx, (m & one) ? 1 : 0);
            f |= kRefined;
          }
    } else {  // cleanup
      for (int k = 0; k < h; k += 4)
        for (int x = 0; x < w; ++x) {
          int y = k;
          const int y_end = std::min(k + 4, h);
          if (y_end - k == 4 &&
              !((F(x, k) | F(x, k + 1) | F(x, k + 2) | F(x, k + 3)) & (kNeighbours | kSig | kVisit))) {
            int run = 0;
            while (run < 4 && !(mag[size_t(k + run) * w + x] & one)) ++run;
            mq.Encode(kCtxRl, run != 4);
            if (run == 4) continue;
            mq.Encode(kCtxUni, run >> 1);
            mq.Encode(kCtxUni, run & 1);
            y = k + run;
            CodeSignificant(x, y);
            ++y;
          }
          for (; y < y_end; ++y) {
            const uint32_t f = F(x, y);
            if (f & (kSig | kVisit)) continue;
            const int v = (mag[size_t(y) * w + x] & one) ? 1 : 0;
            mq.Encode(zc[f & kNeighbours], v);
            if (v) CodeSignificant(x, y);
          }
        }
      for (int y = 0; y < h; ++y)
        for (int x = 0; x < w; ++x) F(x, y) &= ~uint32_t(kVisit);
    }

    cumwmsedec += WeightedMsedec(nmsedec, level, orient, bpno);
    Pass pass;
    pass.distortiondec = cumwmsedec;
    if (passtype == 2 && bpno == 0) {  // the last pass ends the codeword
      mq.Flush();
      pass.rate = mq.NumBytes();
    } else {
      pass.rate = mq.NumBytes() + 3;
    }
    cb.passes.push_back(pass);
    if (++passtype == 3) {
      passtype = 0;
      --bpno;
    }
  }

  const uint32_t total = mq.NumBytes();
  cb.data.assign(mq.buf.begin() + 1, mq.buf.begin() + 1 + total);
  uint32_t last_rate = total;
  for (size_t p = cb.passes.size(); p-- > 0;) {
    if (cb.passes[p].rate > last_rate) {
      cb.passes[p].rate = last_rate;
    } else {
      last_rate = cb.passes[p].rate;
    }
  }
  for (Pass& pass : cb.passes)
    if (pass.rate > 0 && mq.buf[pass.rate] == 0xFF) --pass.rate;  // buf[rate] is data[rate - 1]
}

// ------------------------------------------------------------------ forward DWT

// opj_dwt_encode_1 for the 5/3 filter with cas 0 (a tile at the origin):
// `x` holds one line, the low-pass results go to the even positions.
void Fdwt53Line(int32_t* x, int len) {
  const int sn = (len + 1) / 2, dn = len / 2;
  if (!(dn > 0 || sn > 1)) return;
  auto S = [&](int i) -> int32_t& { return x[2 * i]; };
  auto D = [&](int i) -> int32_t& { return x[2 * i + 1]; };
  auto Sc = [&](int i) { return S(i < 0 ? 0 : i >= sn ? sn - 1 : i); };
  auto Dc = [&](int i) { return D(i < 0 ? 0 : i >= dn ? dn - 1 : i); };
  for (int i = 0; i < dn; ++i) D(i) -= (Sc(i) + Sc(i + 1)) >> 1;
  for (int i = 0; i < sn; ++i) S(i) += (Dc(i - 1) + Dc(i) + 2) >> 2;
}

// Five levels, columns then rows at each, the low-pass half first (as
// opj_dwt_encode deinterleaves).
void ForwardDwt(std::vector<int32_t>& data, int w, const int* rws, const int* rhs) {
  std::vector<int32_t> line(size_t(std::max(w, int(data.size() / size_t(w)))));
  for (int r = kResolutions - 1; r >= 1; --r) {
    const int rw = rws[r], rh = rhs[r];
    const int sn_h = rhs[r - 1], sn_w = rws[r - 1];
    for (int x = 0; x < rw; ++x) {
      for (int y = 0; y < rh; ++y) line[size_t(y)] = data[size_t(y) * w + x];
      Fdwt53Line(line.data(), rh);
      for (int i = 0; i < sn_h; ++i) data[size_t(i) * w + x] = line[size_t(2 * i)];
      for (int i = 0; i < rh - sn_h; ++i) data[size_t(sn_h + i) * w + x] = line[size_t(2 * i + 1)];
    }
    for (int y = 0; y < rh; ++y) {
      int32_t* row = data.data() + size_t(y) * w;
      std::copy(row, row + rw, line.begin());
      Fdwt53Line(line.data(), rw);
      for (int i = 0; i < sn_w; ++i) row[i] = line[size_t(2 * i)];
      for (int i = 0; i < rw - sn_w; ++i) row[sn_w + i] = line[size_t(2 * i + 1)];
    }
  }
}

// ------------------------------------------------------------------ tier-2

// opj_bio_t in writing mode: a byte after 0xFF holds 7 bits.
struct BitWriter {
  std::vector<uint8_t>* out;  // null: count only
  size_t bytes = 0;
  uint32_t buf = 0;
  int ct = 8;
  void ByteOut() {
    buf = (buf << 8) & 0xFFFF;
    ct = buf == 0xFF00 ? 7 : 8;
    if (out) out->push_back(uint8_t(buf >> 8));
    ++bytes;
  }
  void Bit(uint32_t b) {
    if (ct == 0) ByteOut();
    --ct;
    buf |= b << ct;
  }
  void Write(uint32_t v, int n) {
    for (int i = n - 1; i >= 0; --i) Bit((v >> i) & 1);
  }
  void Flush() {
    ByteOut();
    if (ct == 7) ByteOut();
  }
};

struct Band {
  int orient, level;
  int x0, y0, w, h;  // in the tile component's buffer
  int numbps;        // Mb: the exponent plus the guard bits less one
  int cw = 0, ch = 0;
  std::vector<CodeBlock> blocks;
  TagTree incl, imsb;
};

struct Component {
  std::vector<int32_t> data;
  std::vector<Band> bands[kResolutions];
};

int FloorLog2(uint32_t v) {
  int l = 0;
  while (v >>= 1) ++l;
  return l;
}

// opj_t2_encode_packet for layer 0 of one resolution of one component; the
// packet's bytes go to `out` unless it is null.
size_t EncodePacket(std::vector<Band>& bands, std::vector<uint8_t>* out) {
  BitWriter bio{out};
  for (Band& band : bands) {
    band.incl.Reset();
    band.imsb.Reset();
    for (size_t b = 0; b < band.blocks.size(); ++b) band.imsb.SetValue(int(b), band.numbps - band.blocks[b].numbps);
  }
  bio.Bit(1);  // OpenJPEG never writes an empty packet's 0
  for (Band& band : bands) {
    for (size_t b = 0; b < band.blocks.size(); ++b)
      if (band.blocks[b].layer_passes) band.incl.SetValue(int(b), 0);
    for (size_t b = 0; b < band.blocks.size(); ++b) {
      const CodeBlock& cb = band.blocks[b];
      band.incl.Encode(bio, int(b), 1);
      if (!cb.layer_passes) continue;
      band.imsb.Encode(bio, int(b), 999);
      const int n = cb.layer_passes;
      if (n == 1) {
        bio.Bit(0);
      } else if (n == 2) {
        bio.Write(2, 2);
      } else if (n <= 5) {
        bio.Write(0xC | (n - 3), 4);
      } else if (n <= 36) {
        bio.Write(0x1E0 | (n - 6), 9);
      } else {
        bio.Write(0xFF80 | (n - 37), 16);
      }
      // One codeword segment: only the last pass of the layer ends one.
      const int numlenbits = 3;
      const int increment =
          std::max(0, FloorLog2(cb.layer_len) + 1 - (numlenbits + FloorLog2(uint32_t(n))));
      for (int i = 0; i < increment; ++i) bio.Bit(1);
      bio.Bit(0);
      bio.Write(cb.layer_len, numlenbits + increment + FloorLog2(uint32_t(n)));
    }
  }
  bio.Flush();
  size_t bytes = bio.bytes;
  for (const Band& band : bands)
    for (const CodeBlock& cb : band.blocks) {
      if (!cb.layer_passes) continue;
      if (out) out->insert(out->end(), cb.data.begin(), cb.data.begin() + cb.layer_len);
      bytes += cb.layer_len;
    }
  return bytes;
}

// ------------------------------------------------------------------ encoder

struct Encoder {
  int w, h, nc;
  int rws[kResolutions], rhs[kResolutions];
  std::vector<Component> comps;
  int64_t stats[kNumStats] = {};
  double threshold = 0;

  // opj_tcd_makelayer for layer 0; -1 keeps every pass. Returns whether every
  // code-block keeps as many passes as before.
  bool MakeLayer(double thresh) {
    bool same = true;
    for (Component& comp : comps)
      for (auto& bands : comp.bands)
        for (Band& band : bands)
          for (CodeBlock& cb : band.blocks) {
            int n = 0;
            if (thresh < 0) {
              n = int(cb.passes.size());
            } else {
              for (size_t p = 0; p < cb.passes.size(); ++p) {
                const Pass& pass = cb.passes[p];
                uint32_t dr;
                double dd;
                if (n == 0) {
                  dr = pass.rate;
                  dd = pass.distortiondec;
                } else {
                  dr = pass.rate - cb.passes[size_t(n - 1)].rate;
                  dd = pass.distortiondec - cb.passes[size_t(n - 1)].distortiondec;
                }
                if (!dr) {
                  if (dd != 0) n = int(p) + 1;
                  continue;
                }
                if (thresh - (dd / dr) < DBL_EPSILON) n = int(p) + 1;
              }
            }
            same = same && cb.layer_passes == n;
            cb.layer_passes = n;
            cb.layer_len = n ? cb.passes[size_t(n - 1)].rate : 0;
          }
    return same;
  }

  // The packets in LRCP order; their bytes go to `out` unless it is null.
  size_t EncodePackets(std::vector<uint8_t>* out) {
    size_t bytes = 0;
    for (int r = 0; r < kResolutions; ++r)
      for (Component& comp : comps) bytes += EncodePacket(comp.bands[r], out);
    return bytes;
  }

  void Setup(const uint8_t* pixels) {
    for (int r = 0; r < kResolutions; ++r) {
      const int shift = kResolutions - 1 - r;
      rws[r] = int(CeilShift(w, shift));
      rhs[r] = int(CeilShift(h, shift));
    }
    comps.resize(size_t(nc));
    for (int c = 0; c < nc; ++c) {
      Component& comp = comps[size_t(c)];
      const int channel = nc == 3 ? 2 - c : 0;  // BGR in, R, G, B out
      comp.data.resize(size_t(w) * h);
      for (size_t i = 0; i < comp.data.size(); ++i) comp.data[i] = int32_t(pixels[i * size_t(nc) + channel]) - 128;
      ForwardDwt(comp.data, w, rws, rhs);
      for (int r = 0; r < kResolutions; ++r) {
        const int level = kResolutions - 1 - r;
        auto add = [&](int orient, int x0, int y0, int bw, int bh) {
          Band band;
          band.orient = orient;
          band.level = level;
          band.x0 = x0;
          band.y0 = y0;
          band.w = bw;
          band.h = bh;
          const int gain = orient == 0 ? 0 : orient == 3 ? 2 : 1;
          band.numbps = 8 + gain + kGuardBits - 1;
          band.cw = int(CeilShift(bw, kCodeBlockLog));
          band.ch = int(CeilShift(bh, kCodeBlockLog));
          for (int j = 0; j < band.ch; ++j)
            for (int i = 0; i < band.cw; ++i) {
              CodeBlock cb;
              cb.x0 = x0 + (i << kCodeBlockLog);
              cb.y0 = y0 + (j << kCodeBlockLog);
              cb.w = std::min(1 << kCodeBlockLog, bw - (i << kCodeBlockLog));
              cb.h = std::min(1 << kCodeBlockLog, bh - (j << kCodeBlockLog));
              band.blocks.push_back(std::move(cb));
            }
          band.incl.Build(band.cw, band.ch);
          band.imsb.Build(band.cw, band.ch);
          comp.bands[r].push_back(std::move(band));
        };
        if (r == 0) {
          add(0, 0, 0, rws[0], rhs[0]);
        } else {
          const int lw = rws[r - 1], lh = rhs[r - 1];
          add(1, lw, 0, rws[r] - lw, lh);
          add(2, 0, lh, lw, rhs[r] - lh);
          add(3, lw, lh, rws[r] - lw, rhs[r] - lh);
        }
      }
    }
  }

  static int64_t CeilShift(int64_t v, int s) { return (v + (int64_t{1} << s) - 1) >> s; }

  void Tier1() {
    std::vector<uint32_t> mag, flags;
    std::vector<uint8_t> neg;
    MqEncoder mq;
    for (Component& comp : comps)
      for (auto& bands : comp.bands)
        for (Band& band : bands)
          for (CodeBlock& cb : band.blocks) {
            EncodeCodeBlock(cb, comp.data.data(), w, band.orient, band.level, mag, neg, flags, mq);
            ++stats[kCodeBlocks];
            stats[kZeroBlocks] += cb.passes.empty();
            stats[kPasses] += int64_t(cb.passes.size());
          }
  }

  // opj_j2k_update_rates for one tile and one layer: the packets' byte budget.
  // With one tile and no tile-part stride, everything written before the tile
  // comes off the budget.
  uint32_t Budget(float rate, int64_t bytes_before_tile) const {
    const uint32_t size_pixel = uint32_t(nc) * 8, bits_empty = 8;
    float budget = float((double(size_pixel) * uint32_t(w) * uint32_t(h)) / (rate * float(bits_empty)));
    budget -= float(bytes_before_tile);
    if (budget < 30.0f) budget = 30.0f;
    return uint32_t(std::ceil(budget));
  }

  // opj_tcd_rateallocate with cp_disto_alloc and one layer.
  void RateAllocate(float rate, int64_t bytes_before_tile) {
    if (rate <= 1.0f) {  // lossless: every pass
      threshold = -1;
      MakeLayer(-1);
      return;
    }
    double min = DBL_MAX, max = 0;
    for (Component& comp : comps)
      for (auto& bands : comp.bands)
        for (Band& band : bands)
          for (CodeBlock& cb : band.blocks)
            for (size_t p = 0; p < cb.passes.size(); ++p) {
              const Pass& pass = cb.passes[p];
              int32_t dr;
              double dd;
              if (p == 0) {
                dr = int32_t(pass.rate);
                dd = pass.distortiondec;
              } else {
                dr = int32_t(pass.rate - cb.passes[p - 1].rate);
                dd = pass.distortiondec - cb.passes[p - 1].distortiondec;
              }
              if (dr == 0) continue;
              const double rdslope = dd / dr;
              if (rdslope < min) min = rdslope;
              if (rdslope > max) max = rdslope;
            }
    const uint32_t maxlen = Budget(rate, bytes_before_tile);
    stats[kBudget] = maxlen;
    double lo = min, hi = max, thresh = 0, stable_thresh = 0;
    bool last_fit = false;
    for (int i = 0; i < 128; ++i) {
      const double new_thresh = (lo + hi) / 2;
      // OpenJPEG stops once the threshold moves by less than 5e-6 of itself.
      if (std::fabs(new_thresh - thresh) <= 0.5 * 1e-5 * thresh) break;
      thresh = new_thresh;
      ++stats[kIterations];
      // Tier-2 measures the packets only when the passes kept have changed.
      const bool same = MakeLayer(thresh) && i != 0;
      bool fits = last_fit;
      if (!same) {
        ++stats[kTrials];
        fits = EncodePackets(nullptr) <= maxlen;
      }
      if (!fits) {
        lo = thresh;
        last_fit = false;
        continue;
      }
      hi = thresh;
      stable_thresh = thresh;
      last_fit = true;
    }
    threshold = stable_thresh == 0 ? thresh : stable_thresh;
    MakeLayer(threshold);
  }
};

void Put16(std::vector<uint8_t>& o, uint32_t v) {
  o.push_back(uint8_t(v >> 8));
  o.push_back(uint8_t(v));
}

void Put32(std::vector<uint8_t>& o, uint32_t v) {
  Put16(o, v >> 16);
  Put16(o, v & 0xFFFF);
}

// SOC, SIZ, COD, QCD and COM as OpenJPEG writes them under OpenCV's parameters.
void MainHeader(std::vector<uint8_t>& o, int w, int h, int nc) {
  Put16(o, 0xFF4F);
  Put16(o, 0xFF51);
  Put16(o, uint32_t(38 + 3 * nc));
  Put16(o, 0);  // Rsiz
  Put32(o, uint32_t(w));
  Put32(o, uint32_t(h));
  Put32(o, 0);
  Put32(o, 0);
  Put32(o, uint32_t(w));  // one tile
  Put32(o, uint32_t(h));
  Put32(o, 0);
  Put32(o, 0);
  Put16(o, uint32_t(nc));
  for (int c = 0; c < nc; ++c) {
    o.push_back(7);  // 8 bits unsigned
    o.push_back(1);
    o.push_back(1);
  }
  Put16(o, 0xFF52);
  Put16(o, 12);
  o.push_back(0);        // Scod
  o.push_back(0);        // LRCP
  Put16(o, 1);           // layers
  o.push_back(0);        // no MCT
  o.push_back(kLevels);  // decomposition levels
  o.push_back(kCodeBlockLog - 2);
  o.push_back(kCodeBlockLog - 2);
  o.push_back(0);  // code-block style
  o.push_back(1);  // 5/3 reversible
  const int bands = 3 * kLevels + 1;
  Put16(o, 0xFF5C);
  Put16(o, uint32_t(3 + bands));
  o.push_back(kGuardBits << 5);  // no quantisation
  for (int b = 0; b < bands; ++b) {
    const int orient = b == 0 ? 0 : (b - 1) % 3 + 1;
    const int gain = orient == 0 ? 0 : orient == 3 ? 2 : 1;
    o.push_back(uint8_t((8 + gain) << 3));
  }
  const size_t n = sizeof(kComment) - 1;
  Put16(o, 0xFF64);
  Put16(o, uint32_t(4 + n));
  Put16(o, 1);  // Latin text
  o.insert(o.end(), kComment, kComment + n);
}

}  // namespace

extern "C" {

// Encodes `pixels` (h x w x nc uint8, nc 1 or 3 in BGR order) into a JPEG 2000
// codestream at `per_mille` (cv2's IMWRITE_JPEG2000_COMPRESSION_X1000, 1 to
// 1000); `bytes_before` is the length of what the file holds before the
// codestream (the JP2 boxes and the jp2c box header). Returns the
// codestream's length, -1 if it does not fit `capacity` (the needed length is
// in stats[kPacketBytes]), -2 if a side is below 32 (5 decomposition levels),
// -3 on other invalid arguments. `stats` (kNumStats int64) receives the
// counts; `threshold` the slope threshold of the layer (-1: every pass).
int64_t sr_j2k_encode(const uint8_t* pixels, int h, int w, int nc, int per_mille, int64_t bytes_before,
                      uint8_t* out, int64_t capacity, int64_t* stats, double* threshold) {
  if (nc != 1 && nc != 3) return -3;
  if (w < (1 << kLevels) || h < (1 << kLevels)) return -2;
  try {
    Encoder enc;
    enc.w = w;
    enc.h = h;
    enc.nc = nc;
    enc.Setup(pixels);
    enc.Tier1();
    std::vector<uint8_t> cs;
    MainHeader(cs, w, h, nc);
    const float rate = 1000.f / float(std::min(std::max(per_mille, 1), 1000));
    enc.RateAllocate(rate, bytes_before + int64_t(cs.size()));
    std::vector<uint8_t> packets;
    enc.EncodePackets(&packets);
    for (Component& comp : enc.comps)
      for (auto& bands : comp.bands)
        for (Band& band : bands)
          for (CodeBlock& cb : band.blocks) {
            enc.stats[kPassesKept] += cb.layer_passes;
            enc.stats[kBlocksCut] += cb.layer_passes < int(cb.passes.size());
          }
    enc.stats[kPacketBytes] = int64_t(packets.size());
    Put16(cs, 0xFF90);
    Put16(cs, 10);
    Put16(cs, 0);                                     // tile 0
    Put32(cs, uint32_t(12 + 2 + packets.size()));     // Psot
    cs.push_back(0);                                  // TPsot
    cs.push_back(1);                                  // TNsot
    Put16(cs, 0xFF93);
    cs.insert(cs.end(), packets.begin(), packets.end());
    Put16(cs, 0xFFD9);
    if (stats) std::memcpy(stats, enc.stats, sizeof(enc.stats));
    if (threshold) *threshold = enc.threshold;
    if (int64_t(cs.size()) > capacity) return -1;
    std::memcpy(out, cs.data(), cs.size());
    return int64_t(cs.size());
  } catch (const std::exception&) {
    return -3;
  }
}

}  // extern "C"
