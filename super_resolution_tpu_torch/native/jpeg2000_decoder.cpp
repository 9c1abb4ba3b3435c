// JPEG 2000 Part 1 codestream decoder: the serial half of
// super_resolution_tpu_torch/utils/jpeg2000.py.
//
// Decodes one codestream (SOC .. EOC) into integer component planes the way
// OpenJPEG 2.5 (the library behind cv2.imread's JPEG 2000 reader) does:
//   * main and tile-part headers: SIZ, COD / COC, QCD / QCC, RGN, POC, PPM /
//     PPT, SOT / SOD, COM; TLM / PLM / PLT / CRG are skipped. Any number of
//     tiles, tile-parts in any order, image and tile offsets; tiles decoded in
//     OpenJPEG's order (a tile as soon as its last tile-part by TNsot is read,
//     the others at EOC in index order), which is the order PPM's packet
//     headers are read in.
//   * tier-2: packet headers (tag trees, zero-length packets, inclusion /
//     zero bit-planes / pass counts / Lblock, the codeword segments of each
//     code-block style), read from the tile data or from the merged PPM / PPT
//     segments (opj_j2k_merge_ppm / opj_j2k_merge_ppt: by Z index), SOP and
//     EPH markers, the five progression orders and POC's progression changes
//     (opj_pi_update_decode_poc: each entry's layers from 0, each packet read
//     once), any number of layers, precinct partitions.
//   * tier-1: the MQ decoder, the raw (bypass) decoder and the significance,
//     refinement and cleanup passes under every code-block style (BYPASS,
//     RESET, TERMALL, VSC, PTERM, SEGSYM) as opj_t1_decode_cblk decodes them;
//     code-blocks of 4x4 to 64x64 (1024 samples at most); passes cut by the
//     rate control, reconstructed as OpenJPEG does (a coefficient keeps one
//     fractional bit: the half of the first undecoded bit-plane); the RGN
//     shift (opj_t1_clbl_decode_processor's scaling down of the region).
//   * dequantisation: reversible (the fractional bit dropped, rounding to
//     zero) and irreversible scalar derived / expounded with the guard bits.
//   * inverse DWT: 5/3 in integers; 9/7 in single-precision float in
//     OpenJPEG 2.5's order of operations (opj_v8dwt_decode: the two scalings,
//     then four lifts), rows first, 0 to 32 levels at any size and offset.
//   * inverse RCT / ICT (the ICT in opj_mct_decode_real's float order), the
//     DC level shift, lrintf rounding of the float path, clamp to precision.
// Refused with code -2 and the feature's name: HTJ2K (Part 15) and Part 2
// extensions.
//
// The float path needs IEEE single precision without contraction into fused
// multiply-adds, as the library's default flags give on x86-64.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <exception>
#include <string>
#include <vector>

#include "jpeg2000_tables.h"

namespace {

struct Fail {
  int code;  // -1 corrupt, -2 unsupported
  std::string message;
};

[[noreturn]] void Corrupt(const std::string& m) { throw Fail{-1, m}; }
[[noreturn]] void Unsupported(const std::string& m) { throw Fail{-2, m}; }

inline int64_t CeilDiv(int64_t a, int64_t b) { return (a + b - 1) / b; }
inline int64_t CeilDivPow2(int64_t a, int n) { return (a + (int64_t{1} << n) - 1) >> n; }
inline int64_t FloorDivPow2(int64_t a, int n) { return a >> n; }

// Counts kept over one decode, in this order (utils/jpeg2000.STATS).
enum Stat {
  kTiles, kTileParts, kPackets, kEmptyPackets, kSopMarkers, kEphMarkers, kCodeBlocks, kTruncatedBlocks,
  kPasses, kLayers, kReversible, kIrreversible, kRct, kIct, kPrecinctsDefined, kLrcp, kRlcp, kRpcl, kPcrl,
  kCprl, kSegments, kRawPasses, kRoiComponents, kPocEntries, kPackedHeaderBytes, kNumStats
};

// ------------------------------------------------------------------ parameters

struct CodStyle {
  int csty = 0;  // bit 0: precinct sizes given
  int levels = 0, xcb = 6, ycb = 6, cblksty = 0, transform = 0;
  uint8_t ppx[33], ppy[33];
};

struct Cod {
  int scod = 0, prog = 0, layers = 1, mct = 0;
  CodStyle style;
};

// One progression order change of POC (the layers always start at 0 when decoding).
struct Poc {
  int res0, comp0, layer1, res1, comp1, prog;
};

struct QStyle {
  int style = 0, guard = 0, n = 0;
  int expn[97] = {}, mant[97] = {};
};

// The COD / COC / QCD / QCC of one header (the main header or a tile's).
struct HeaderSet {
  bool has_cod = false, has_qcd = false;
  Cod cod;
  QStyle qcd;
  std::vector<bool> has_coc, has_qcc;
  std::vector<CodStyle> coc;
  std::vector<QStyle> qcc;
  std::vector<int> roishift;  // RGN's SPrgn per component
  std::vector<Poc> pocs;      // a tile's start as the main header's (OpenJPEG copies its default tile)
  void Resize(int n) {
    has_coc.assign(n, false);
    has_qcc.assign(n, false);
    coc.resize(n);
    qcc.resize(n);
    roishift.assign(n, 0);
  }
};

// Packed packet headers: the PPM or PPT marker segments by Z index, then merged.
struct Packed {
  std::vector<std::vector<uint8_t>> by_z;
  std::vector<bool> present;
  std::vector<uint8_t> data;
  size_t pos = 0;
  bool any = false;
  void Add(int z, const uint8_t* p, size_t n, const char* name) {
    any = true;
    if (size_t(z) >= by_z.size()) {
      by_z.resize(size_t(z) + 1);
      present.resize(size_t(z) + 1, false);
    }
    if (present[size_t(z)]) Corrupt(std::string(name) + ": Z index " + std::to_string(z) + " read twice");
    present[size_t(z)] = true;
    by_z[size_t(z)].assign(p, p + n);
  }
};

struct Component {
  int prec = 8;
  bool sgnd = false;
  int dx = 1, dy = 1;
};

struct TileInput {
  HeaderSet header;
  std::vector<uint8_t> data;  // the tile-parts' bodies, in codestream order
  bool complete = false;  // its last tile-part by TNsot read
  Packed ppt;
};

// ------------------------------------------------------------------ readers

struct Reader {
  const uint8_t* p;
  size_t n, pos = 0;
  void Need(size_t k) const {
    if (pos + k > n) Corrupt("the codestream is truncated");
  }
  int U8() {
    Need(1);
    return p[pos++];
  }
  int U16() {
    Need(2);
    int v = (p[pos] << 8) | p[pos + 1];
    pos += 2;
    return v;
  }
  uint32_t U32() {
    Need(4);
    uint32_t v = (uint32_t(p[pos]) << 24) | (uint32_t(p[pos + 1]) << 16) | (uint32_t(p[pos + 2]) << 8) | p[pos + 3];
    pos += 4;
    return v;
  }
};

// Packet-header bits (opj_bio): a byte after 0xFF holds 7 bits; reading past
// the end gives zeros.
struct BitReader {
  const uint8_t* bp;
  const uint8_t* end;
  const uint8_t* start;
  uint32_t buf = 0;
  int ct = 0;
  BitReader(const uint8_t* s, const uint8_t* e) : bp(s), end(e), start(s) {}
  void ByteIn() {
    buf = (buf << 8) & 0xFFFF;
    ct = buf == 0xFF00 ? 7 : 8;
    if (bp < end) buf |= *bp++;
  }
  int Bit() {
    if (ct == 0) ByteIn();
    --ct;
    return (buf >> ct) & 1;
  }
  uint32_t Read(int n) {
    uint32_t v = 0;
    for (int i = n - 1; i >= 0; --i) v |= uint32_t(Bit()) << i;
    return v;
  }
  void Align() {
    if ((buf & 0xFF) == 0xFF) ByteIn();
    ct = 0;
  }
  size_t Consumed() const { return size_t(bp - start); }
};

// ------------------------------------------------------------------ MQ decoder

struct Mqc {
  std::vector<uint8_t> buf;  // a segment's bytes and two 0xFF, as opj_mqc_init_dec
  const uint8_t* bp = nullptr;
  uint32_t a = 0, c = 0;
  int ct = 0;
  uint8_t state[kNumCtx], mps[kNumCtx];

  void ResetStates() {
    std::memset(state, 0, sizeof(state));
    std::memset(mps, 0, sizeof(mps));
    state[kCtxUni] = 46;
    state[kCtxRl] = 3;
    state[kCtxZc] = 4;
  }
  void ByteIn() {
    if (*bp == 0xFF) {
      if (bp[1] > 0x8F) {
        c += 0xFF00;
        ct = 8;
      } else {
        ++bp;
        c += uint32_t(*bp) << 9;
        ct = 7;
      }
    } else {
      ++bp;
      c += uint32_t(*bp) << 8;
      ct = 8;
    }
  }
  void Init(const uint8_t* data, size_t len) {
    buf.assign(data, data + len);
    buf.push_back(0xFF);
    buf.push_back(0xFF);
    bp = buf.data();
    c = uint32_t(*bp) << 16;
    ByteIn();
    c <<= 7;
    ct -= 7;
    a = 0x8000;
  }
  // A raw (bypass) segment, as opj_mqc_raw_init_dec: the same two 0xFF after it.
  void InitRaw(const uint8_t* data, size_t len) {
    buf.assign(data, data + len);
    buf.push_back(0xFF);
    buf.push_back(0xFF);
    bp = buf.data();
    c = 0;
    ct = 0;
  }
  // opj_mqc_raw_decode: a byte after 0xFF holds 7 bits; a byte above 0x8F there
  // (the end of the segment) is not read, and gives ones.
  int RawDecode() {
    if (ct == 0) {
      if (c == 0xFF) {
        if (*bp > 0x8F) {
          c = 0xFF;
          ct = 8;
        } else {
          c = *bp++;
          ct = 7;
        }
      } else {
        c = *bp++;
        ct = 8;
      }
    }
    --ct;
    return int((c >> ct) & 1);
  }
  void Renorm() {
    do {
      if (ct == 0) ByteIn();
      a <<= 1;
      c <<= 1;
      --ct;
    } while (a < 0x8000);
  }
  int Decode(int cx) {
    const MqState& s = kMq[state[cx]];
    int d;
    a -= s.qe;
    if ((c >> 16) < s.qe) {
      if (a < s.qe) {
        d = mps[cx];
        state[cx] = s.nmps;
      } else {
        d = 1 - mps[cx];
        if (s.sw) mps[cx] = uint8_t(1 - mps[cx]);
        state[cx] = s.nlps;
      }
      a = s.qe;
      Renorm();
    } else {
      c -= uint32_t(s.qe) << 16;
      if ((a & 0x8000) == 0) {
        if (a < s.qe) {
          d = 1 - mps[cx];
          if (s.sw) mps[cx] = uint8_t(1 - mps[cx]);
          state[cx] = s.nlps;
        } else {
          d = mps[cx];
          state[cx] = s.nmps;
        }
        Renorm();
      } else {
        d = mps[cx];
      }
    }
    return d;
  }
};

// ------------------------------------------------------------------ tier-1

// The code-block styles of COD / COC's SPcod; PTERM (16) changes nothing when decoding.
enum : int { kBypass = 1, kReset = 2, kTermAll = 4, kVsc = 8, kSegSym = 32 };

// One codeword segment of a code-block (opj_tcd_seg_t): its passes end with a
// terminated codeword or the end of the data.
struct Segment {
  int maxpasses = 0, passes = 0, newpasses = 0;
  size_t len = 0, newlen = 0;
};

// opj_t2_init_seg: at most one pass a segment under TERMALL; under BYPASS 10
// passes (the 4 most significant bit-planes), then 2 (a raw significance and
// refinement pass) and 1 (a cleanup pass) in turn; else 109.
int MaxPasses(int cblksty, const Segment* previous) {
  if (cblksty & kTermAll) return 1;
  if (cblksty & kBypass) {
    if (previous == nullptr) return 10;
    return previous->maxpasses == 1 || previous->maxpasses == 10 ? 2 : 1;
  }
  return 109;
}

struct CodeBlock {
  int x0, y0, x1, y1;
  int numbps = 0, lblock = 3, passes = 0;
  std::vector<uint8_t> data;     // the segments' bytes, one after another
  std::vector<Segment> segs;     // none until the code-block is first included
  int first_new = -1;            // the first segment the packet being read brings passes to
};

// Marks the coefficient at `f` significant as MarkSignificant does, but under
// VSC in the first row of a stripe tells the row above nothing (the stripe
// above never sees the one below: opj_t1_update_flags with vsc).
inline void MarkSignificantCausal(uint32_t* f, int fw, bool neg) {
  *f |= kSig;
  f[-1] |= kE | (neg ? uint32_t(kENeg) : 0u);
  f[1] |= kW | (neg ? uint32_t(kWNeg) : 0u);
  f[fw - 1] |= kNe;
  f[fw] |= kN | (neg ? uint32_t(kNNeg) : 0u);
  f[fw + 1] |= kNw;
}

// Decodes one code-block into `out` (w*h coefficients in OpenJPEG's units: two
// per unit of the quantised value, so the half of the first undecoded plane
// is kept) as opj_t1_decode_cblk, with the RGN shift `roishift` added to its
// bit-planes. Counts its segments and raw passes into `stats`.
void DecodeCodeBlock(const CodeBlock& cb, int orient, int cblksty, int roishift, std::vector<int32_t>& out,
                     std::vector<uint32_t>& flags, Mqc& mq, int64_t* stats) {
  const int w = cb.x1 - cb.x0, h = cb.y1 - cb.y0;
  out.assign(size_t(w) * h, 0);
  if (cb.passes == 0 || w <= 0 || h <= 0) return;
  const int fw = w + 2;
  flags.assign(size_t(fw) * (h + 2), 0);
  const T1Tables& t = Tables();
  const uint8_t* zc = t.zc[orient];
  const bool vsc = cblksty & kVsc;
  bool raw = false;
  auto F = [&](int x, int y) -> uint32_t& { return flags[size_t(y + 1) * fw + x + 1]; };
  auto MakeSignificant = [&](int x, int y, bool neg) {
    if (vsc && (y & 3) == 0) {
      MarkSignificantCausal(&F(x, y), fw, neg);
    } else {
      MarkSignificant(&F(x, y), fw, neg);
    }
  };
  auto DecodeSign = [&](uint32_t f) {
    if (raw) return bool(mq.RawDecode());
    int s = t.sc[SignContextIndex(f)];
    return bool(mq.Decode(s >> 1) ^ (s & 1));
  };

  int bpno = roishift + cb.numbps;  // OpenJPEG's bpno_plus_one
  mq.ResetStates();
  int passtype = 2;
  size_t offset = 0;
  for (const Segment& seg : cb.segs) {
    if (seg.len > cb.data.size() - offset) Corrupt("a code-block's segments are longer than its data");
    // Raw where BYPASS is on, below the 4 most significant bit-planes (counted without the RGN shift, as
    // OpenJPEG counts them), for significance and refinement passes.
    const bool seg_raw = (cblksty & kBypass) && passtype < 2 && bpno <= cb.numbps - 4;
    if (seg_raw) {
      mq.InitRaw(cb.data.data() + offset, seg.len);
    } else {
      mq.Init(cb.data.data() + offset, seg.len);
    }
    ++stats[kSegments];
    offset += seg.len;
    for (int pass = 0; pass < seg.passes && bpno >= 1; ++pass) {
      const int32_t one = int32_t(1) << bpno, half = one >> 1, oneplushalf = one | half;
      raw = seg_raw && passtype < 2;  // a cleanup pass is always arithmetic-coded
      if (raw) ++stats[kRawPasses];
      if (passtype == 0) {  // significance propagation
        for (int k = 0; k < h; k += 4)
          for (int x = 0; x < w; ++x)
            for (int y = k; y < std::min(k + 4, h); ++y) {
              uint32_t& f = F(x, y);
              if ((f & kSig) || !(f & kNeighbours)) continue;
              if (raw ? mq.RawDecode() : mq.Decode(zc[f & kNeighbours])) {
                bool neg = DecodeSign(f);
                out[size_t(y) * w + x] = neg ? -oneplushalf : oneplushalf;
                MakeSignificant(x, y, neg);
              }
              f |= kVisit;
            }
      } else if (passtype == 1) {  // magnitude refinement
        for (int k = 0; k < h; k += 4)
          for (int x = 0; x < w; ++x)
            for (int y = k; y < std::min(k + 4, h); ++y) {
              uint32_t& f = F(x, y);
              if ((f & (kSig | kVisit)) != kSig) continue;
              int v;
              if (raw) {
                v = mq.RawDecode();
              } else {
                v = mq.Decode((f & kRefined) ? kCtxMag + 2 : (f & kNeighbours) ? kCtxMag + 1 : kCtxMag);
              }
              int32_t& d = out[size_t(y) * w + x];
              d += (v ^ (d < 0)) ? half : -half;
              f |= kRefined;
            }
      } else {  // cleanup
        for (int k = 0; k < h; k += 4)
          for (int x = 0; x < w; ++x) {
            int y = k;
            const int y_end = std::min(k + 4, h);
            if (y_end - k == 4 && !((F(x, k) | F(x, k + 1) | F(x, k + 2) | F(x, k + 3)) &
                                    (kNeighbours | kSig | kVisit))) {
              if (!mq.Decode(kCtxRl)) continue;
              int run = mq.Decode(kCtxUni) << 1;
              run |= mq.Decode(kCtxUni);
              y = k + run;
              uint32_t& f = F(x, y);
              bool neg = DecodeSign(f);
              out[size_t(y) * w + x] = neg ? -oneplushalf : oneplushalf;
              MakeSignificant(x, y, neg);
              ++y;
            }
            for (; y < y_end; ++y) {
              uint32_t& f = F(x, y);
              if (!(f & (kSig | kVisit))) {
                if (mq.Decode(zc[f & kNeighbours])) {
                  bool neg = DecodeSign(f);
                  out[size_t(y) * w + x] = neg ? -oneplushalf : oneplushalf;
                  MakeSignificant(x, y, neg);
                }
              }
            }
          }
        for (int y = 0; y < h; ++y)
          for (int x = 0; x < w; ++x) F(x, y) &= ~kVisit;
        if (cblksty & kSegSym) {  // four UNIFORM symbols, 0xA when intact (OpenJPEG does not check them)
          for (int i = 0; i < 4; ++i) mq.Decode(kCtxUni);
        }
      }
      if ((cblksty & kReset) && !seg_raw) mq.ResetStates();
      if (++passtype == 3) {
        passtype = 0;
        --bpno;
      }
    }
  }
}

// ------------------------------------------------------------------ tile structures

struct PrecinctBand {
  int cw = 0, ch = 0;
  TagTree incl, imsb;
  std::vector<CodeBlock> blocks;
};

struct Band {
  int x0, y0, x1, y1;
  int orient;  // 0 LL, 1 HL, 2 LH, 3 HH
  int numbps;  // Mb
  float stepsize;
  bool Empty() const { return x0 >= x1 || y0 >= y1; }
};

struct Resolution {
  int x0, y0, x1, y1;
  int pdx, pdy, pw, ph;
  int nbands;
  Band bands[3];
  std::vector<std::vector<PrecinctBand>> precincts;  // [precinct][band]
};

struct TileComp {
  int x0, y0, x1, y1;
  int roishift = 0;
  CodStyle style;
  QStyle quant;
  std::vector<Resolution> res;
  std::vector<int32_t> idata;
  std::vector<float> fdata;
};

// ------------------------------------------------------------------ inverse DWT

// One line of the 5/3 synthesis in place: `x` holds the interleaved samples
// (low-pass at even positions when cas is 0, at odd ones when it is 1).
void Idwt53Line(int32_t* x, int len, int cas) {
  if (len == 1) {
    if (cas) x[0] /= 2;
    return;
  }
  if (len <= 0) return;
  auto at = [&](int i) { return x[i < 0 ? -i : i >= len ? 2 * (len - 1) - i : i]; };
  for (int i = cas; i < len; i += 2) x[i] -= (at(i - 1) + at(i + 1) + 2) >> 2;
  for (int i = 1 - cas; i < len; i += 2) x[i] += (at(i - 1) + at(i + 1)) >> 1;
}

// One line of the 9/7 synthesis in place, as opj_v8dwt_decode computes it.
void Idwt97Line(float* x, int len, int cas) {
  const int sn = cas ? len / 2 : (len + 1) / 2;
  const int dn = len - sn;
  if (cas == 0 ? !(dn > 0 || sn > 1) : !(sn > 0 || dn > 1)) return;
  const float k = 1.230174105f, two_inv_k = 1.625732422f;
  for (int i = cas; i < len; i += 2) x[i] = x[i] * k;
  for (int i = 1 - cas; i < len; i += 2) x[i] = x[i] * two_inv_k;
  auto lift = [&](int first, float c) {
    for (int i = first; i < len; i += 2) {
      const bool has_left = i > 0, has_right = i + 1 < len;
      if (has_left && has_right) {
        x[i] = x[i] + ((x[i - 1] + x[i + 1]) * c);
      } else {
        x[i] = x[i] + x[has_left ? i - 1 : i + 1] * (c + c);
      }
    }
  };
  lift(cas, -0.443506852f);     // delta, on the low-pass samples
  lift(1 - cas, -0.882911075f);  // gamma, on the high-pass samples
  lift(cas, 0.052980118f);      // beta
  lift(1 - cas, 1.586134342f);   // alpha
}

// The synthesis up to resolution `resolutions` - 1, in the top left of the
// tile-component's buffer (opj_dwt_decode with fewer resolutions).
template <typename T, typename Line>
void InverseDwt(TileComp& tc, std::vector<T>& data, Line line, int resolutions) {
  const int w = tc.x1 - tc.x0;
  std::vector<T> tmp;
  for (size_t r = 1; r < size_t(resolutions); ++r) {
    const Resolution& lo = tc.res[r - 1];
    const Resolution& cur = tc.res[r];
    const int rw = cur.x1 - cur.x0, rh = cur.y1 - cur.y0;
    const int sw = lo.x1 - lo.x0, sh = lo.y1 - lo.y0;
    const int cas_x = cur.x0 & 1, cas_y = cur.y0 & 1;
    tmp.resize(size_t(std::max(rw, rh)));
    for (int y = 0; y < rh && rw > 0; ++y) {
      T* row = data.data() + size_t(y) * w;
      for (int i = 0; i < sw; ++i) tmp[size_t(cas_x + 2 * i)] = row[i];
      for (int i = 0; i < rw - sw; ++i) tmp[size_t(1 - cas_x + 2 * i)] = row[sw + i];
      line(tmp.data(), rw, cas_x);
      std::copy(tmp.begin(), tmp.begin() + rw, row);
    }
    for (int x = 0; x < rw && rh > 0; ++x) {
      T* col = data.data() + x;
      for (int i = 0; i < sh; ++i) tmp[size_t(cas_y + 2 * i)] = col[size_t(i) * w];
      for (int i = 0; i < rh - sh; ++i) tmp[size_t(1 - cas_y + 2 * i)] = col[size_t(sh + i) * w];
      line(tmp.data(), rh, cas_y);
      for (int i = 0; i < rh; ++i) col[size_t(i) * w] = tmp[size_t(i)];
    }
  }
}

// ------------------------------------------------------------------ decoder

struct Decoder {
  const uint8_t* data = nullptr;
  size_t size = 0;
  int64_t stats[kNumStats] = {};

  // SIZ
  uint32_t xsiz = 0, ysiz = 0, xosiz = 0, yosiz = 0, xtsiz = 0, ytsiz = 0, xtosiz = 0, ytosiz = 0;
  std::vector<Component> comps;
  int numtx = 0, numty = 0;
  HeaderSet main;
  std::vector<TileInput> tiles;
  std::vector<int> completed;  // tiles in the order their last tile-part (by TNsot) was read
  // Per component the highest resolution a packet of the tile being decoded
  // was read for (OpenJPEG's resno_decoded): a POC may leave resolutions out.
  std::vector<int> resno_decoded;
  Packed ppm;
  size_t first_sot = 0;

  int NumComps() const { return int(comps.size()); }

  void ReadSiz(Reader& r) {
    const int rsiz = r.U16();
    if (rsiz & 0x4000) Unsupported("HTJ2K (Part 15) codestreams");
    if (rsiz & 0x8000) Unsupported("Part 2 extensions (Rsiz 0x" + Hex(rsiz) + ")");
    xsiz = r.U32();
    ysiz = r.U32();
    xosiz = r.U32();
    yosiz = r.U32();
    xtsiz = r.U32();
    ytsiz = r.U32();
    xtosiz = r.U32();
    ytosiz = r.U32();
    int n = r.U16();
    if (n < 1 || n > 16384) Corrupt("SIZ: invalid number of components");
    if (xosiz >= xsiz || yosiz >= ysiz) Corrupt("SIZ: empty image area");
    if (xtsiz == 0 || ytsiz == 0) Corrupt("SIZ: zero tile size");
    if (xtosiz > xosiz || ytosiz > yosiz || uint64_t(xtosiz) + xtsiz <= xosiz ||
        uint64_t(ytosiz) + ytsiz <= yosiz)
      Corrupt("SIZ: invalid tile offset");
    comps.resize(size_t(n));
    for (auto& c : comps) {
      int s = r.U8();
      c.prec = (s & 0x7F) + 1;
      c.sgnd = s >> 7;
      c.dx = r.U8();
      c.dy = r.U8();
      if (c.dx == 0 || c.dy == 0) Corrupt("SIZ: zero component sub-sampling");
      if (c.prec > 38) Corrupt("SIZ: component precision above 38 bits");
    }
    numtx = int(CeilDiv(int64_t(xsiz) - xtosiz, xtsiz));
    numty = int(CeilDiv(int64_t(ysiz) - ytosiz, ytsiz));
    if (int64_t(numtx) * numty > 65535) Corrupt("SIZ: more than 65535 tiles");
    main.Resize(n);
    resno_decoded.assign(size_t(n), 0);
  }

  static std::string Hex(int v) {
    char s[16];
    std::snprintf(s, sizeof(s), "%04X", v);
    return s;
  }

  void ReadCodStyle(Reader& r, int csty, CodStyle& s) {
    s.csty = csty;
    s.levels = r.U8();
    if (s.levels > 32) Corrupt("COD/COC: more than 32 decomposition levels");
    s.xcb = r.U8() + 2;
    s.ycb = r.U8() + 2;
    if (s.xcb > 10 || s.ycb > 10 || s.xcb + s.ycb > 12) Corrupt("COD/COC: invalid code-block size");
    s.cblksty = r.U8();
    if (s.cblksty & 0x40) Unsupported("HTJ2K (Part 15) high-throughput code-blocks");
    if (s.cblksty & 0x80) Unsupported("Part 2 extensions (code-block style 0x" + Hex(s.cblksty) + ")");
    s.transform = r.U8();
    if (s.transform > 1) Unsupported("Part 2 extensions (arbitrary wavelet transform " + std::to_string(s.transform) + ")");
    for (int i = 0; i <= s.levels; ++i) {
      if (csty & 1) {
        int b = r.U8();
        s.ppx[i] = uint8_t(b & 15);
        s.ppy[i] = uint8_t(b >> 4);
        if (i > 0 && (s.ppx[i] == 0 || s.ppy[i] == 0)) Corrupt("COD/COC: a precinct of size 1 above resolution 0");
      } else {
        s.ppx[i] = s.ppy[i] = 15;
      }
    }
  }

  void ReadQuant(Reader& r, size_t end, QStyle& q) {
    int s = r.U8();
    q.style = s & 0x1F;
    q.guard = s >> 5;
    if (q.style > 2) Corrupt("QCD/QCC: invalid quantisation style");
    q.n = 0;
    while (r.pos < end) {
      if (q.n >= 97) Corrupt("QCD/QCC: too many sub-bands");
      if (q.style == 0) {
        q.expn[q.n] = r.U8() >> 3;
        q.mant[q.n] = 0;
      } else {
        int v = r.U16();
        q.expn[q.n] = v >> 11;
        q.mant[q.n] = v & 0x7FF;
      }
      ++q.n;
      if (q.style == 1) break;
    }
    if (q.n == 0) Corrupt("QCD/QCC: no step sizes");
    if (q.style == 1)  // derived: as opj_j2k_read_SQcd_SQcc
      for (int b = 1; b < 97; ++b) {
        q.expn[b] = std::max(q.expn[0] - (b - 1) / 3, 0);
        q.mant[b] = q.mant[0];
      }
  }

  int ReadComponentIndex(Reader& r, const char* marker = "COC/QCC") {
    int c = NumComps() < 257 ? r.U8() : r.U16();
    if (c >= NumComps()) Corrupt(std::string(marker) + ": component index out of range");
    return c;
  }

  // POC (opj_j2k_read_poc): entries appended to the header's; LYEpoc clamped to
  // the layers known when it is read, CEpoc to the components.
  void ReadPoc(Reader& r, size_t size, HeaderSet& hs, int layers) {
    const size_t room = NumComps() <= 256 ? 1 : 2, chunk = 5 + 2 * room;
    if (size == 0 || size % chunk != 0) Corrupt("POC: invalid length");
    if (hs.pocs.size() + size / chunk >= 32) Corrupt("POC: more than 31 progression order changes");
    for (size_t i = 0; i < size / chunk; ++i) {
      Poc p;
      p.res0 = r.U8();
      p.comp0 = room == 1 ? r.U8() : r.U16();
      p.layer1 = std::min(r.U16(), layers);
      p.res1 = r.U8();
      p.comp1 = std::min(room == 1 ? r.U8() : r.U16(), NumComps());
      p.prog = r.U8();
      hs.pocs.push_back(p);
    }
  }

  // One marker segment of the main header (`tile` null) or of a tile-part header.
  void ReadSegment(Reader& r, int marker, HeaderSet& hs, TileInput* tile = nullptr) {
    const size_t len = size_t(r.U16());
    if (len < 2) Corrupt("a marker segment shorter than its length field");
    r.Need(len - 2);
    const size_t end = r.pos + len - 2;
    switch (marker) {
      case 0xFF52: {  // COD
        hs.has_cod = true;
        hs.cod.scod = r.U8();
        hs.cod.prog = r.U8();
        hs.cod.layers = r.U16();
        hs.cod.mct = r.U8();
        if (hs.cod.prog > 4) Corrupt("COD: invalid progression order");
        if (hs.cod.layers == 0) Corrupt("COD: zero layers");
        if (hs.cod.mct > 1) Unsupported("Part 2 extensions (multiple component transform " +
                                        std::to_string(hs.cod.mct) + ")");
        ReadCodStyle(r, hs.cod.scod & 1, hs.cod.style);
        break;
      }
      case 0xFF53: {  // COC
        int c = ReadComponentIndex(r);
        int csty = r.U8();
        hs.has_coc[size_t(c)] = true;
        ReadCodStyle(r, csty & 1, hs.coc[size_t(c)]);
        break;
      }
      case 0xFF5C:  // QCD
        hs.has_qcd = true;
        ReadQuant(r, end, hs.qcd);
        break;
      case 0xFF5D: {  // QCC
        int c = ReadComponentIndex(r);
        hs.has_qcc[size_t(c)] = true;
        ReadQuant(r, end, hs.qcc[size_t(c)]);
        break;
      }
      case 0xFF5E: {  // RGN (opj_j2k_read_rgn: Srgn is not checked)
        if (len - 2 != (NumComps() <= 256 ? 3u : 4u)) Corrupt("RGN: invalid length");
        const int c = ReadComponentIndex(r, "RGN");
        r.U8();  // Srgn
        hs.roishift[size_t(c)] = r.U8();
        break;
      }
      case 0xFF5F:  // POC
        ReadPoc(r, len - 2, hs, hs.has_cod ? hs.cod.layers : tile ? main.cod.layers : 0);
        break;
      case 0xFF60:  // PPM: the main header only
        if (tile) Corrupt("a PPM marker in a tile-part header");
        if (len - 2 < 2) Corrupt("PPM: invalid length");
        {
          const int z = r.U8();
          ppm.Add(z, data + r.pos, end - r.pos, "PPM");
        }
        break;
      case 0xFF61:  // PPT: tile-part headers only, and not beside PPM
        if (!tile) Corrupt("a PPT marker in the main header");
        if (ppm.any) Corrupt("a PPT marker where the main header has PPM");
        if (len - 2 < 2) Corrupt("PPT: invalid length");
        {
          const int z = r.U8();
          tile->ppt.Add(z, data + r.pos, end - r.pos, "PPT");
        }
        break;
      case 0xFF50:
        Unsupported("HTJ2K (Part 15) codestreams (CAP)");
      case 0xFF70: case 0xFF71: case 0xFF72: case 0xFF73: case 0xFF74: case 0xFF75: case 0xFF76: case 0xFF77:
      case 0xFF78: case 0xFF79:
        Unsupported("Part 2 extensions (marker 0x" + Hex(marker) + ")");
      default:  // COM, TLM, PLM, PLT, CRG and unknown markers are skipped
        break;
    }
    if (r.pos > end) Corrupt("marker 0x" + Hex(marker) + " overruns its segment");
    r.pos = end;
  }

  void ReadHeaders() {
    Reader r{data, size};
    if (r.U16() != 0xFF4F) Corrupt("no SOC marker");
    if (r.U16() != 0xFF51) Corrupt("no SIZ marker after SOC");
    {
      size_t len = size_t(r.U16());
      size_t start = r.pos;
      ReadSiz(r);
      if (r.pos - start + 2 != len) Corrupt("SIZ: length disagrees with the number of components");
    }
    for (;;) {
      int marker = r.U16();
      if (marker == 0xFF90) {
        first_sot = r.pos - 2;
        break;
      }
      if ((marker >> 8) != 0xFF) Corrupt("expected a marker in the main header");
      ReadSegment(r, marker, main);
    }
    if (!main.has_cod) Corrupt("no COD marker in the main header");
    if (!main.has_qcd) Corrupt("no QCD marker in the main header");
    MergePpm();
  }

  // opj_j2k_merge_ppm: the PPM segments in Z order, each Nppm field dropped (a
  // tile-part's headers may run on into the next segment); the headers are
  // then read one after another, whatever tile-part an Nppm named.
  void MergePpm() {
    if (!ppm.any) return;
    size_t remaining = 0;
    for (size_t z = 0; z < ppm.by_z.size(); ++z) {
      if (!ppm.present[z]) continue;
      const std::vector<uint8_t>& seg = ppm.by_z[z];
      size_t pos = std::min(remaining, seg.size());
      ppm.data.insert(ppm.data.end(), seg.begin(), seg.begin() + long(pos));
      remaining -= pos;
      while (pos < seg.size()) {
        if (seg.size() - pos < 4) Corrupt("PPM: not enough bytes to read Nppm");
        const size_t n = (size_t(seg[pos]) << 24) | (size_t(seg[pos + 1]) << 16) | (size_t(seg[pos + 2]) << 8) |
                         seg[pos + 3];
        pos += 4;
        const size_t take = std::min(n, seg.size() - pos);
        ppm.data.insert(ppm.data.end(), seg.begin() + long(pos), seg.begin() + long(pos + take));
        pos += take;
        remaining = n - take;
      }
    }
    if (remaining != 0) Corrupt("PPM: the headers are shorter than their Nppm");
    stats[kPackedHeaderBytes] += int64_t(ppm.data.size());
  }

  // opj_j2k_merge_ppt: a tile's PPT segments (over all its tile-parts) in Z order.
  static void MergePpt(Packed& ppt) {
    for (size_t z = 0; z < ppt.by_z.size(); ++z)
      if (ppt.present[z]) ppt.data.insert(ppt.data.end(), ppt.by_z[z].begin(), ppt.by_z[z].end());
  }

  void ReadTileParts() {
    tiles.assign(size_t(numtx) * numty, TileInput{});
    for (auto& t : tiles) {
      t.header.Resize(NumComps());
      t.header.roishift = main.roishift;  // OpenJPEG starts each tile from the main header's RGN and POC
      t.header.pocs = main.pocs;
    }
    Reader r{data, size};
    r.pos = first_sot;
    for (;;) {
      const size_t sot = r.pos;
      int marker = r.U16();
      if (marker == 0xFFD9) break;
      if (marker != 0xFF90) Corrupt("expected SOT or EOC after a tile-part");
      if (r.U16() != 10) Corrupt("SOT: invalid length");
      int isot = r.U16();
      uint32_t psot = r.U32();
      const int tpsot = r.U8();
      const int tnsot = r.U8();
      if (isot >= int(tiles.size())) Corrupt("SOT: tile index out of range");
      TileInput& tile = tiles[size_t(isot)];
      for (;;) {
        int m = r.U16();
        if (m == 0xFF93) break;
        if ((m >> 8) != 0xFF) Corrupt("expected a marker in a tile-part header");
        ReadSegment(r, m, tile.header, &tile);
      }
      if (tnsot != 0 && tpsot + 1 == tnsot && !tile.complete) {
        tile.complete = true;
        completed.push_back(isot);
      }
      size_t end;
      if (psot == 0) {
        if (size < 2 || size - 2 < r.pos) Corrupt("the codestream is truncated");
        end = size - 2;  // to the EOC
      } else {
        end = sot + psot;
        if (end > size || end < r.pos) Corrupt("the codestream is truncated: a tile-part is longer than the data");
      }
      tile.data.insert(tile.data.end(), data + r.pos, data + end);
      ++stats[kTileParts];
      r.pos = end;
    }
  }

  // ---------------------------------------------------------------- tile decoding

  void SetupTileComp(TileComp& tc, const Component& comp, int64_t tx0, int64_t ty0, int64_t tx1, int64_t ty1) {
    tc.x0 = int(CeilDiv(tx0, comp.dx));
    tc.y0 = int(CeilDiv(ty0, comp.dy));
    tc.x1 = int(CeilDiv(tx1, comp.dx));
    tc.y1 = int(CeilDiv(ty1, comp.dy));
    const CodStyle& s = tc.style;
    const QStyle& q = tc.quant;
    const int nres = s.levels + 1;
    if (q.style != 1 && q.n < 3 * s.levels + 1) Corrupt("QCD/QCC: fewer step sizes than sub-bands");
    tc.res.resize(size_t(nres));
    for (int r = 0; r < nres; ++r) {
      Resolution& res = tc.res[size_t(r)];
      const int level = nres - 1 - r;
      res.x0 = int(CeilDivPow2(tc.x0, level));
      res.y0 = int(CeilDivPow2(tc.y0, level));
      res.x1 = int(CeilDivPow2(tc.x1, level));
      res.y1 = int(CeilDivPow2(tc.y1, level));
      res.pdx = s.ppx[r];
      res.pdy = s.ppy[r];
      const int64_t px0 = FloorDivPow2(res.x0, res.pdx) << res.pdx;
      const int64_t py0 = FloorDivPow2(res.y0, res.pdy) << res.pdy;
      const int64_t px1 = CeilDivPow2(res.x1, res.pdx) << res.pdx;
      const int64_t py1 = CeilDivPow2(res.y1, res.pdy) << res.pdy;
      res.pw = res.x0 == res.x1 ? 0 : int((px1 - px0) >> res.pdx);
      res.ph = res.y0 == res.y1 ? 0 : int((py1 - py0) >> res.pdy);
      int64_t cbgx0, cbgy0;
      int cbgw, cbgh;
      if (r == 0) {
        cbgx0 = px0;
        cbgy0 = py0;
        cbgw = res.pdx;
        cbgh = res.pdy;
        res.nbands = 1;
      } else {
        cbgx0 = CeilDivPow2(px0, 1);
        cbgy0 = CeilDivPow2(py0, 1);
        cbgw = res.pdx - 1;
        cbgh = res.pdy - 1;
        res.nbands = 3;
      }
      const int cbw = std::min(s.xcb, cbgw), cbh = std::min(s.ycb, cbgh);
      for (int b = 0; b < res.nbands; ++b) {
        Band& band = res.bands[b];
        const int orient = r == 0 ? 0 : b + 1;
        band.orient = orient;
        if (r == 0) {
          band.x0 = res.x0;
          band.y0 = res.y0;
          band.x1 = res.x1;
          band.y1 = res.y1;
        } else {
          const int64_t xob = orient & 1, yob = orient >> 1;
          band.x0 = int(CeilDivPow2(tc.x0 - (int64_t{1} << level) * xob, level + 1));
          band.y0 = int(CeilDivPow2(tc.y0 - (int64_t{1} << level) * yob, level + 1));
          band.x1 = int(CeilDivPow2(tc.x1 - (int64_t{1} << level) * xob, level + 1));
          band.y1 = int(CeilDivPow2(tc.y1 - (int64_t{1} << level) * yob, level + 1));
        }
        const int qi = r == 0 ? 0 : 3 * (r - 1) + b + 1;
        const int expn = q.expn[qi], mant = q.mant[qi];
        const int rb = comp.prec + (s.transform == 1 ? (orient == 0 ? 0 : orient == 3 ? 2 : 1) : 0);
        band.stepsize = float((1.0 + mant / 2048.0) * std::pow(2.0, double(rb - expn))) * 1.0f;
        band.numbps = expn + q.guard - 1;
      }
      res.precincts.assign(size_t(res.pw) * res.ph, std::vector<PrecinctBand>(size_t(res.nbands)));
      for (int p = 0; p < res.pw * res.ph; ++p)
        for (int b = 0; b < res.nbands; ++b) {
          const Band& band = res.bands[b];
          PrecinctBand& pb = res.precincts[size_t(p)][size_t(b)];
          if (band.Empty()) continue;
          const int64_t gx0 = cbgx0 + int64_t(p % res.pw) * (int64_t{1} << cbgw);
          const int64_t gy0 = cbgy0 + int64_t(p / res.pw) * (int64_t{1} << cbgh);
          const int64_t x0 = std::max<int64_t>(gx0, band.x0), y0 = std::max<int64_t>(gy0, band.y0);
          const int64_t x1 = std::min<int64_t>(gx0 + (int64_t{1} << cbgw), band.x1);
          const int64_t y1 = std::min<int64_t>(gy0 + (int64_t{1} << cbgh), band.y1);
          if (x0 >= x1 || y0 >= y1) continue;
          const int64_t bx0 = FloorDivPow2(x0, cbw) << cbw, by0 = FloorDivPow2(y0, cbh) << cbh;
          pb.cw = int(((CeilDivPow2(x1, cbw) << cbw) - bx0) >> cbw);
          pb.ch = int(((CeilDivPow2(y1, cbh) << cbh) - by0) >> cbh);
          pb.incl.Build(pb.cw, pb.ch);
          pb.imsb.Build(pb.cw, pb.ch);
          pb.blocks.resize(size_t(pb.cw) * pb.ch);
          for (int i = 0; i < pb.cw * pb.ch; ++i) {
            CodeBlock& cb = pb.blocks[size_t(i)];
            const int64_t cx0 = bx0 + int64_t(i % pb.cw) * (int64_t{1} << cbw);
            const int64_t cy0 = by0 + int64_t(i / pb.cw) * (int64_t{1} << cbh);
            cb.x0 = int(std::max(cx0, x0));
            cb.y0 = int(std::max(cy0, y0));
            cb.x1 = int(std::min(cx0 + (int64_t{1} << cbw), x1));
            cb.y1 = int(std::min(cy0 + (int64_t{1} << cbh), y1));
          }
        }
    }
  }

  static int NumPasses(BitReader& bio) {
    if (!bio.Bit()) return 1;
    if (!bio.Bit()) return 2;
    int n = int(bio.Read(2));
    if (n != 3) return 3 + n;
    n = int(bio.Read(5));
    if (n != 31) return 6 + n;
    return 37 + int(bio.Read(7));
  }

  static int FloorLog2(int v) {
    int l = 0;
    while (v > 1) {
      v >>= 1;
      ++l;
    }
    return l;
  }

  // Reads one packet at `pos` of the tile data; returns the position after it.
  // The header comes from `packed` (PPM / PPT, from its `pos` on) where there
  // is one: then SOP stays in the tile data and EPH follows the header.
  size_t ReadPacket(const std::vector<uint8_t>& td, size_t pos, Resolution& res, int precinct, int layer,
                    bool sop, bool eph, int cblksty, Packed* packed) {
    ++stats[kPackets];
    const uint8_t* base = td.data();
    const size_t n = td.size();
    if (sop && pos + 6 <= n && base[pos] == 0xFF && base[pos + 1] == 0x91) {
      pos += 6;
      ++stats[kSopMarkers];
    }
    const uint8_t* head = packed ? packed->data.data() : base;
    const size_t head_end = packed ? packed->data.size() : n;
    size_t head_pos = packed ? packed->pos : pos;
    BitReader bio(head + head_pos, head + head_end);
    auto end_header = [&]() {
      bio.Align();
      head_pos += bio.Consumed();
      if (eph) {  // required after every packet header (OpenJPEG 2.5 fails the decode without one)
        if (head_end - head_pos < 2 || head[head_pos] != 0xFF || head[head_pos + 1] != 0x92)
          Corrupt("a packet header without its EPH marker");
        head_pos += 2;
        ++stats[kEphMarkers];
      }
      if (packed) {
        packed->pos = head_pos;
      } else {
        pos = head_pos;
      }
    };
    std::vector<PrecinctBand>& bands = res.precincts[size_t(precinct)];
    if (!bio.Bit()) {
      end_header();
      ++stats[kEmptyPackets];
      return pos;
    }
    for (int b = 0; b < res.nbands; ++b) {
      if (res.bands[b].Empty()) continue;
      PrecinctBand& pb = bands[size_t(b)];
      for (int i = 0; i < pb.cw * pb.ch; ++i) {
        CodeBlock& cb = pb.blocks[size_t(i)];
        const bool first = cb.segs.empty();
        if (!(first ? pb.incl.Decode(bio, i, layer + 1) : bio.Bit())) continue;
        if (first) {
          int k = 0;
          while (!pb.imsb.Decode(bio, i, k)) ++k;
          cb.numbps = res.bands[b].numbps + 1 - k;
          cb.lblock = 3;
          ++stats[kCodeBlocks];
        }
        int passes = NumPasses(bio);
        while (bio.Bit()) ++cb.lblock;
        cb.passes += passes;
        stats[kPasses] += passes;
        // The passes fill the last segment, then new ones (opj_t2_init_seg); each segment they reach has a
        // length of Lblock + floor(log2(its new passes)) bits.
        if (first) {
          cb.segs.push_back(Segment{MaxPasses(cblksty, nullptr)});
        } else if (cb.segs.back().passes == cb.segs.back().maxpasses) {
          cb.segs.push_back(Segment{MaxPasses(cblksty, &cb.segs.back())});
        }
        cb.first_new = int(cb.segs.size()) - 1;
        for (;;) {
          Segment& seg = cb.segs.back();
          seg.newpasses = std::min(seg.maxpasses - seg.passes, passes);
          const int bits = cb.lblock + FloorLog2(seg.newpasses);
          // OpenJPEG refuses a length field wider than 32 bits.
          if (bits > 32) Corrupt("a code-block's length field has " + std::to_string(bits) + " bits");
          seg.newlen = bio.Read(bits);
          passes -= seg.newpasses;
          if (passes <= 0) break;
          cb.segs.push_back(Segment{MaxPasses(cblksty, &seg)});
        }
      }
    }
    end_header();
    for (int b = 0; b < res.nbands; ++b) {
      if (res.bands[b].Empty()) continue;
      for (CodeBlock& cb : bands[size_t(b)].blocks) {
        if (cb.first_new < 0) continue;
        for (size_t s = size_t(cb.first_new); s < cb.segs.size(); ++s) {
          Segment& seg = cb.segs[s];
          if (pos > n || seg.newlen > n - pos) Corrupt("a code-block's data runs past its tile");
          cb.data.insert(cb.data.end(), base + pos, base + pos + seg.newlen);
          pos += seg.newlen;
          seg.len += seg.newlen;
          seg.passes += seg.newpasses;
          seg.newlen = 0;
          seg.newpasses = 0;
        }
        cb.first_new = -1;
      }
    }
    return pos;
  }

  // The packets of one tile: in its progression order (B.12), or in the
  // order of its POC entries, each walking its ranges as OpenJPEG's packet
  // iterators do (opj_pi_next_*), from layer 0, reading each packet once.
  void ReadPackets(TileInput& in, std::vector<TileComp>& tcs, const Cod& cod, int64_t tx0, int64_t ty0,
                   int64_t tx1, int64_t ty1) {
    const int nc = NumComps();
    int maxres = 0, maxprec = 0;
    for (auto& tc : tcs) {
      maxres = std::max(maxres, int(tc.res.size()));
      for (auto& r : tc.res) maxprec = std::max(maxprec, r.pw * r.ph);
    }
    const int layers = cod.layers;
    const bool sop = cod.scod & 2, eph = cod.scod & 4;
    Packed* packed = nullptr;
    if (ppm.any) {
      packed = &ppm;
    } else if (in.ppt.any) {
      MergePpt(in.ppt);
      stats[kPackedHeaderBytes] += int64_t(in.ppt.data.size());
      packed = &in.ppt;
    }
    std::vector<bool> done(size_t(layers) * maxres * nc * std::max(maxprec, 1), false);
    size_t pos = 0;
    auto packet = [&](int l, int r, int c, int p) {
      size_t index = ((size_t(l) * maxres + r) * nc + c) * size_t(std::max(maxprec, 1)) + p;
      if (done[index]) return;
      done[index] = true;
      pos = ReadPacket(in.data, pos, tcs[size_t(c)].res[size_t(r)], p, l, sop, eph, tcs[size_t(c)].style.cblksty,
                       packed);
      resno_decoded[size_t(c)] = std::max(resno_decoded[size_t(c)], r);
    };
    auto num_res = [&](int c) { return int(tcs[size_t(c)].res.size()); };
    // The precinct of component c, resolution r at grid point (x, y), or -1 (opj_pi_next_rpcl's tests).
    auto precinct_at = [&](int c, int r, int64_t x, int64_t y) -> int {
      const TileComp& tc = tcs[size_t(c)];
      if (r >= int(tc.res.size())) return -1;
      const Resolution& res = tc.res[size_t(r)];
      const Component& comp = comps[size_t(c)];
      const int level = int(tc.res.size()) - 1 - r;
      const int64_t dxl = int64_t(comp.dx) << level, dyl = int64_t(comp.dy) << level;
      const int64_t trx0 = CeilDiv(tx0, dxl), try0 = CeilDiv(ty0, dyl);
      const int64_t trx1 = CeilDiv(tx1, dxl), try1 = CeilDiv(ty1, dyl);
      const int rpx = res.pdx + level, rpy = res.pdy + level;
      if (!(y % (int64_t(comp.dy) << rpy) == 0 || (y == ty0 && ((try0 << level) % (int64_t{1} << rpy)) != 0)))
        return -1;
      if (!(x % (int64_t(comp.dx) << rpx) == 0 || (x == tx0 && ((trx0 << level) % (int64_t{1} << rpx)) != 0)))
        return -1;
      if (res.pw == 0 || res.ph == 0 || trx0 == trx1 || try0 == try1) return -1;
      const int64_t pi = FloorDivPow2(CeilDiv(x, dxl), res.pdx) - FloorDivPow2(trx0, res.pdx);
      const int64_t pj = FloorDivPow2(CeilDiv(y, dyl), res.pdy) - FloorDivPow2(try0, res.pdy);
      return int(pi + pj * res.pw);
    };
    auto steps = [&](int c_first, int c_last, int64_t& dx, int64_t& dy) {
      dx = dy = 0;
      for (int c = c_first; c < c_last; ++c) {
        const TileComp& tc = tcs[size_t(c)];
        for (size_t r = 0; r < tc.res.size(); ++r) {
          const int level = int(tc.res.size()) - 1 - int(r);
          const int64_t sx = int64_t(comps[size_t(c)].dx) << (tc.res[r].pdx + level);
          const int64_t sy = int64_t(comps[size_t(c)].dy) << (tc.res[r].pdy + level);
          dx = dx ? std::min(dx, sx) : sx;
          dy = dy ? std::min(dy, sy) : sy;
        }
      }
    };
    ++stats[kLrcp + cod.prog];
    std::vector<Poc> entries = in.header.pocs;
    if (entries.empty()) {
      entries.push_back(Poc{0, 0, layers, maxres, nc, cod.prog});
    } else {
      stats[kPocEntries] += int64_t(entries.size());
    }
    for (const Poc& e : entries) {
      const int l1 = std::min(e.layer1, layers), r0 = e.res0, r1 = e.res1, c0 = e.comp0, c1 = e.comp1;
      if (c0 >= nc) continue;  // opj_pi_next_*: an invalid CSpoc ends the entry
      switch (e.prog) {
        case 0:  // LRCP
          for (int l = 0; l < l1; ++l)
            for (int r = r0; r < r1; ++r)
              for (int c = c0; c < c1; ++c)
                if (r < num_res(c)) {
                  const Resolution& res = tcs[size_t(c)].res[size_t(r)];
                  for (int p = 0; p < res.pw * res.ph; ++p) packet(l, r, c, p);
                }
          break;
        case 1:  // RLCP
          for (int r = r0; r < r1; ++r)
            for (int l = 0; l < l1; ++l)
              for (int c = c0; c < c1; ++c)
                if (r < num_res(c)) {
                  const Resolution& res = tcs[size_t(c)].res[size_t(r)];
                  for (int p = 0; p < res.pw * res.ph; ++p) packet(l, r, c, p);
                }
          break;
        case 2: {  // RPCL: the grid of every component
          int64_t dx, dy;
          steps(0, nc, dx, dy);
          if (dx == 0 || dy == 0) break;
          for (int r = r0; r < r1; ++r)
            for (int64_t y = ty0; y < ty1; y += dy - (y % dy))
              for (int64_t x = tx0; x < tx1; x += dx - (x % dx))
                for (int c = c0; c < c1; ++c) {
                  int p = precinct_at(c, r, x, y);
                  if (p < 0) continue;
                  for (int l = 0; l < l1; ++l) packet(l, r, c, p);
                }
          break;
        }
        case 3: {  // PCRL: the grid of every component
          int64_t dx, dy;
          steps(0, nc, dx, dy);
          if (dx == 0 || dy == 0) break;
          for (int64_t y = ty0; y < ty1; y += dy - (y % dy))
            for (int64_t x = tx0; x < tx1; x += dx - (x % dx))
              for (int c = c0; c < c1; ++c)
                for (int r = r0; r < std::min(r1, num_res(c)); ++r) {
                  int p = precinct_at(c, r, x, y);
                  if (p < 0) continue;
                  for (int l = 0; l < l1; ++l) packet(l, r, c, p);
                }
          break;
        }
        case 4:  // CPRL: each component's own grid
          for (int c = c0; c < c1; ++c) {
            int64_t dx, dy;
            steps(c, c + 1, dx, dy);
            if (dx == 0 || dy == 0) break;
            for (int64_t y = ty0; y < ty1; y += dy - (y % dy))
              for (int64_t x = tx0; x < tx1; x += dx - (x % dx))
                for (int r = r0; r < std::min(r1, num_res(c)); ++r) {
                  int p = precinct_at(c, r, x, y);
                  if (p < 0) continue;
                  for (int l = 0; l < l1; ++l) packet(l, r, c, p);
                }
          }
          break;
        default:  // a progression Part 1 does not define: opj_pi_next reads nothing
          break;
      }
    }
  }

  void DecodeTile(int t, int32_t* out, int64_t plane) {
    TileInput& in = tiles[size_t(t)];
    ++stats[kTiles];
    const int p = t % numtx, q = t / numtx;
    const int64_t tx0 = std::max<int64_t>(xtosiz + int64_t(p) * xtsiz, xosiz);
    const int64_t ty0 = std::max<int64_t>(ytosiz + int64_t(q) * ytsiz, yosiz);
    const int64_t tx1 = std::min<int64_t>(xtosiz + int64_t(p + 1) * xtsiz, xsiz);
    const int64_t ty1 = std::min<int64_t>(ytosiz + int64_t(q + 1) * ytsiz, ysiz);
    const HeaderSet& th = in.header;
    const Cod& cod = th.has_cod ? th.cod : main.cod;
    const int nc = NumComps();
    std::vector<TileComp> tcs(static_cast<size_t>(nc));
    for (int c = 0; c < nc; ++c) {
      TileComp& tc = tcs[size_t(c)];
      tc.style = th.has_coc[size_t(c)] ? th.coc[size_t(c)]
                 : th.has_cod          ? th.cod.style
                 : main.has_coc[size_t(c)] ? main.coc[size_t(c)]
                                           : main.cod.style;
      tc.quant = th.has_qcc[size_t(c)] ? th.qcc[size_t(c)]
                 : th.has_qcd          ? th.qcd
                 : main.has_qcc[size_t(c)] ? main.qcc[size_t(c)]
                                           : main.qcd;
      tc.roishift = th.roishift[size_t(c)];
      if (tc.roishift) ++stats[kRoiComponents];
      if (tc.style.csty & 1) ++stats[kPrecinctsDefined];
      SetupTileComp(tc, comps[size_t(c)], tx0, ty0, tx1, ty1);
    }
    stats[kLayers] = std::max<int64_t>(stats[kLayers], cod.layers);
    std::fill(resno_decoded.begin(), resno_decoded.end(), 0);
    ReadPackets(in, tcs, cod, tx0, ty0, tx1, ty1);
    std::vector<int> decoded(static_cast<size_t>(nc));  // the resolution each component is synthesised to
    for (int c = 0; c < nc; ++c)
      decoded[size_t(c)] = std::min(resno_decoded[size_t(c)], int(tcs[size_t(c)].res.size()) - 1);

    std::vector<int32_t> coefs;
    std::vector<uint32_t> flags;
    Mqc mq;
    for (int c = 0; c < nc; ++c) {
      TileComp& tc = tcs[size_t(c)];
      const int w = tc.x1 - tc.x0, h = tc.y1 - tc.y0;
      const bool reversible = tc.style.transform == 1;
      ++stats[reversible ? kReversible : kIrreversible];
      if (reversible) {
        tc.idata.assign(size_t(w) * h, 0);
      } else {
        tc.fdata.assign(size_t(w) * h, 0.0f);
      }
      for (size_t r = 0; r < tc.res.size(); ++r) {
        Resolution& res = tc.res[r];
        for (auto& prec : res.precincts)
          for (int b = 0; b < res.nbands; ++b) {
            const Band& band = res.bands[b];
            int xoff = 0, yoff = 0;
            if (band.orient & 1) xoff = tc.res[r - 1].x1 - tc.res[r - 1].x0;
            if (band.orient & 2) yoff = tc.res[r - 1].y1 - tc.res[r - 1].y0;
            for (CodeBlock& cb : prec[size_t(b)].blocks) {
              // opj_t1_decode_cblk fails on every code-block, coded or not, past 30 bit-planes with the RGN shift.
              if (tc.roishift + cb.numbps >= 31) Corrupt("a code-block has more than 30 bit-planes");
              if (cb.passes == 0) continue;
              if (cb.passes < 3 * cb.numbps - 2) ++stats[kTruncatedBlocks];
              DecodeCodeBlock(cb, band.orient, tc.style.cblksty, tc.roishift, coefs, flags, mq, stats);
              if (tc.roishift) {  // the region scaled back down: magnitudes at or above 2^roishift (in half units)
                const int32_t threshold = int32_t(1) << tc.roishift;
                for (int32_t& v : coefs) {
                  const int32_t magnitude = v < 0 ? -v : v;
                  if (magnitude >= threshold) v = v < 0 ? -(magnitude >> tc.roishift) : magnitude >> tc.roishift;
                }
              }
              const int cw = cb.x1 - cb.x0, ch = cb.y1 - cb.y0;
              const int x = cb.x0 - band.x0 + xoff, y = cb.y0 - band.y0 + yoff;
              if (reversible) {
                for (int j = 0; j < ch; ++j)
                  for (int i = 0; i < cw; ++i)
                    tc.idata[size_t(y + j) * w + x + i] = coefs[size_t(j) * cw + i] / 2;
              } else {
                const float step = 0.5f * band.stepsize;
                for (int j = 0; j < ch; ++j)
                  for (int i = 0; i < cw; ++i)
                    tc.fdata[size_t(y + j) * w + x + i] = float(coefs[size_t(j) * cw + i]) * step;
              }
              std::vector<uint8_t>().swap(cb.data);
            }
          }
      }
      if (reversible) {
        InverseDwt(tc, tc.idata, Idwt53Line, decoded[size_t(c)] + 1);
      } else {
        InverseDwt(tc, tc.fdata, Idwt97Line, decoded[size_t(c)] + 1);
      }
    }

    if (cod.mct && nc >= 3) {
      if (decoded[0] != decoded[1] || decoded[0] != decoded[2])
        Corrupt("a colour transform over components decoded to different resolutions");
      const size_t n = size_t(tcs[0].x1 - tcs[0].x0) * size_t(tcs[0].y1 - tcs[0].y0);
      for (int c = 1; c < 3; ++c)
        if (size_t(tcs[size_t(c)].x1 - tcs[size_t(c)].x0) * size_t(tcs[size_t(c)].y1 - tcs[size_t(c)].y0) != n)
          Corrupt("a colour transform over components of different sizes");
      const bool rev = tcs[0].style.transform == 1;
      for (int c = 1; c < 3; ++c)
        if ((tcs[size_t(c)].style.transform == 1) != rev)
          Unsupported("a colour transform over components with different wavelet transforms");
      if (rev) {
        ++stats[kRct];
        int32_t *c0 = tcs[0].idata.data(), *c1 = tcs[1].idata.data(), *c2 = tcs[2].idata.data();
        for (size_t i = 0; i < n; ++i) {
          int32_t y = c0[i], u = c1[i], v = c2[i];
          int32_t g = y - ((u + v) >> 2);
          c0[i] = v + g;
          c1[i] = g;
          c2[i] = u + g;
        }
      } else {
        ++stats[kIct];
        float *c0 = tcs[0].fdata.data(), *c1 = tcs[1].fdata.data(), *c2 = tcs[2].fdata.data();
        for (size_t i = 0; i < n; ++i) {
          float y = c0[i], u = c1[i], v = c2[i];
          float r = y + (v * 1.402f);
          float g = y - (u * 0.34413f) - (v * (0.71414f));
          float b = y + (u * 1.772f);
          c0[i] = r;
          c1[i] = g;
          c2[i] = b;
        }
      }
    }

    // DC level shift, rounding and clamping of the decoded resolution, into the
    // output planes where opj_j2k_update_image_data puts it (a resolution below
    // the full one in the top left of its tile's place, on the full grid).
    for (int c = 0; c < nc; ++c) {
      const TileComp& tc = tcs[size_t(c)];
      const Component& comp = comps[size_t(c)];
      const Resolution& res = tc.res[size_t(decoded[size_t(c)])];
      const int64_t x0d = CeilDiv(xosiz, comp.dx), y0d = CeilDiv(yosiz, comp.dy);
      const int64_t cw = CeilDiv(xsiz, comp.dx) - x0d, ch = CeilDiv(ysiz, comp.dy) - y0d;
      int64_t start_x, start_y, off_x, off_y, wd, hd;
      auto place = [](int64_t d0, int64_t dn, int64_t r0, int64_t r1, int64_t& start, int64_t& off, int64_t& n) {
        if (d0 < r0) {
          start = r0 - d0;
          off = 0;
          n = d0 + dn >= r1 ? r1 - r0 : d0 + dn - r0;
        } else {
          start = 0;
          off = d0 - r0;
          n = d0 + dn >= r1 ? r1 - r0 - off : dn;
        }
        if (n < 0) Corrupt("a tile outside the image");
      };
      place(x0d, cw, res.x0, res.x1, start_x, off_x, wd);
      place(y0d, ch, res.y0, res.y1, start_y, off_y, hd);
      const int64_t lo = comp.sgnd ? -(int64_t{1} << (comp.prec - 1)) : 0;
      const int64_t hi = comp.sgnd ? (int64_t{1} << (comp.prec - 1)) - 1 : (int64_t{1} << comp.prec) - 1;
      const int64_t shift = comp.sgnd ? 0 : int64_t{1} << (comp.prec - 1);
      const int w = tc.x1 - tc.x0;
      int32_t* dst = out + plane * c;
      for (int64_t j = 0; j < hd; ++j) {
        int32_t* row = dst + (start_y + j) * cw + start_x;
        const size_t src = size_t(off_y + j) * size_t(w) + size_t(off_x);
        if (tc.style.transform == 1) {
          for (int64_t i = 0; i < wd; ++i)
            row[i] = int32_t(std::clamp<int64_t>(int64_t(tc.idata[src + size_t(i)]) + shift, lo, hi));
        } else {
          for (int64_t i = 0; i < wd; ++i) {
            const float v = tc.fdata[src + size_t(i)];
            int64_t value;
            if (v > float(INT32_MAX)) {
              value = hi;
            } else if (v < float(INT32_MIN)) {
              value = lo;
            } else {
              value = std::clamp<int64_t>(int64_t(std::lrintf(v)) + shift, lo, hi);
            }
            row[i] = int32_t(value);
          }
        }
      }
    }
  }

  // The tiles in OpenJPEG's order: each as soon as its last tile-part is
  // read (no data there fails the decode: opj_j2k_decode_tile), the rest at
  // EOC in index order, where a tile without data is passed over and its
  // place left zero; no tile decoded fails it.
  void DecodeAll(int32_t* out, int64_t plane) {
    ReadTileParts();
    int decoded = 0;
    auto decode = [&](int t) {
      DecodeTile(t, out, plane);
      std::vector<uint8_t>().swap(tiles[size_t(t)].data);
      ++decoded;
    };
    for (int t : completed) {
      if (tiles[size_t(t)].data.empty()) Corrupt("tile " + std::to_string(t) + " has no data");
      decode(t);
    }
    for (int t = 0; t < int(tiles.size()); ++t)
      if (!tiles[size_t(t)].complete && !tiles[size_t(t)].data.empty()) decode(t);
    if (decoded == 0) Corrupt("no tile has data");
  }
};

}  // namespace

extern "C" {

// Image description filled by sr_j2k_decode: the reference grid, the first
// four components, and the counts of one decode (Stat order).
struct SrJ2kInfo {
  int32_t x0, y0, x1, y1, num_components;
  int32_t precision[4], is_signed[4], dx[4], dy[4];
  int64_t stats[kNumStats];
};

// Decodes the codestream in `data`. With `out` null, reads the main header,
// fills `info` and returns 1. Else decodes every tile into `out`: one int32
// plane per component of ceil(x1 / dx) - ceil(x0 / dx) by the same in y
// samples, component planes `plane` values apart (`capacity` values in all),
// fills `info` and returns 0. Errors: -1 corrupt or truncated data, -2 a
// feature this decoder does not support; `message` (`message_len` bytes)
// says which.
int sr_j2k_decode(const uint8_t* data, int64_t size, SrJ2kInfo* info, int32_t* out, int64_t plane,
                  int64_t capacity, char* message, int message_len) {
  Decoder dec;
  dec.data = data;
  dec.size = size_t(size);
  try {
    dec.ReadHeaders();
    std::memset(info, 0, sizeof(*info));
    info->x0 = int32_t(dec.xosiz);
    info->y0 = int32_t(dec.yosiz);
    info->x1 = int32_t(dec.xsiz);
    info->y1 = int32_t(dec.ysiz);
    info->num_components = dec.NumComps();
    for (int c = 0; c < std::min(4, dec.NumComps()); ++c) {
      info->precision[c] = dec.comps[size_t(c)].prec;
      info->is_signed[c] = dec.comps[size_t(c)].sgnd;
      info->dx[c] = dec.comps[size_t(c)].dx;
      info->dy[c] = dec.comps[size_t(c)].dy;
    }
    if (out == nullptr) return 1;
    for (int c = 0; c < dec.NumComps(); ++c) {
      const Component& comp = dec.comps[size_t(c)];
      const int64_t w = CeilDiv(dec.xsiz, comp.dx) - CeilDiv(dec.xosiz, comp.dx);
      const int64_t h = CeilDiv(dec.ysiz, comp.dy) - CeilDiv(dec.yosiz, comp.dy);
      if (w * h > plane || plane * (c + 1) > capacity) Corrupt("the output buffer is too small");
    }
    dec.DecodeAll(out, plane);
    std::memcpy(info->stats, dec.stats, sizeof(dec.stats));
    return 0;
  } catch (const Fail& f) {
    if (message_len > 0) std::snprintf(message, size_t(message_len), "%s", f.message.c_str());
    return f.code;
  } catch (const std::bad_alloc&) {
    if (message_len > 0) std::snprintf(message, size_t(message_len), "out of memory");
    return -1;
  } catch (const std::exception& e) {
    if (message_len > 0) std::snprintf(message, size_t(message_len), "%s", e.what());
    return -1;
  }
}

}  // extern "C"
