// Hand-written Hopper (sm_90a) kernels for the fused MAP objective.
//
// Together the three kernels below replace every mode of the Pallas TPU
// kernel `pallas_data_term_cost_and_grad`
// (super_resolution_tpu/ops/pallas/degrade.py):
//
//   data term                 cost  s^2 sum_k ||D B M_k x - y_k||^2
//                             grad  2 s^2 sum_k M_k^T B^T D^T r_k
//   + fused 2D TV             cost  sum c r^2, r = |dx| + |dy|
//   + fused 3D spectral TV    cost  sum c r^2, r = |dx| + |dy| + |dz|,
//                             dz = x[b+1] - x[b] (zero at the last band)
//   + fused bilateral TV      cost  sum c r^2, r = sum a^(i+j) |x - shift_ij x|
//
// Two further modes serve a solve that is spread over a device mesh:
//
//   shard mode      x is a halo-extended TILE of a larger image. The tile's
//                   origin (u0, v0) in the global image and the global extent
//                   (Hg, Wg) come with the launch; every border test of the
//                   operators runs in GLOBAL coordinates, so halo content
//                   inside the image is data and only the true image border
//                   is a border. Beyond the tile's own array x reads as zero
//                   (memory safety, in local indices). The LR residual is
//                   multiplied by a 0/1 mask of the LR pixels the shard owns
//                   (default: LR pixels inside the global image); what the
//                   gradient puts into the rim is returned for the caller's
//                   scatter-sum. With origin (0, 0), global extent (H, W) and
//                   no mask every test is the one it was and the results are
//                   the same bits. Each kernel is compiled twice from the one
//                   source (template flag SHARD): for a whole image the tile
//                   is a compile-time {0, 0, H, W} and the tests in the
//                   image's coordinates fold into the array-bound tests.
//   spectral halo   with the 3D TV term, the LAST channel of x is a read-only
//                   band owned by the next band shard: its LR residual is
//                   written as zero (no data cost, no data gradient). The
//                   caller gives zero constants on that band, so its own TV
//                   terms vanish, the last real band takes dz against it, and
//                   the gradient's last channel is exactly the cross-shard
//                   +G sign(dz).
//
// The TPU kernel's shift-generic mode (`dynamic_shifts` + `shift_bound`) and
// its channel-block grid (`channel_block`) are not modes here but how every
// launch works: the [K, 2] shifts are read from device memory at run time,
// fractional or negative, of any size (there is no bound and no |shift|
// bucket), so one build serves every motion and a refiner can hand its
// output to the next launch without the host seeing it; and the grid's z
// axis runs over the channels (K * C for the residual), so tens or hundreds
// of bands need no blocking argument -- the TPU blocked them to fit VMEM.
//
// The TPU kernel splits x into s*s polyphase planes and pre-extracts
// overlapping windows because its toolchain rejects strided and runtime
// slices. A CUDA thread reads x[c, s*q + o] directly, so none of that is
// carried over: the kernels index the [C, H, W] image as it lies in memory
// and take the motion shifts as runtime data.
//
// Everything is in gather form: each thread owns one output element and
// reads whatever it needs. No float atomics, so results are identical from
// run to run. Cost partials are accumulated in double, one per block, and
// summed in block order by a one-block kernel.
//
// Semantics that must not be "simplified" (each mirrors the reference):
//  * the warp output is zero outside the image BEFORE the blur reads it, and
//    the blurred-back residual is zero outside the image before the reverse
//    warp reads it (two-stage form; merging warp and blur taps is wrong in a
//    border band);
//  * out(r, c) = x(r - dy, c - dx), bilinear, iy = floor(dy); the adjoint is
//    the warp by (-dx, -dy), not the true transpose;
//  * the blur adjoint is correlation with kernel^T (not the flipped kernel),
//    anchored at size/2 (OpenCV's anchor for even sizes);
//  * sign(0) = 0 in the TV / BTV gradients;
//  * BTV: residual window inclusive [0, P]^2, gradient window exclusive
//    [0, P)^2, overlap contributions sourced at pixel (0, 0) skipped;
//  * data cost x s^2, data gradient x 2 s^2, regulariser terms unscaled.
//
// Bound on this card: an evaluation must read x, y and the constants and
// write the gradient once; the LR residual r (K*C*H*W/s^2 values) is the one
// intermediate that round-trips through device memory, and all neighbour
// re-reads (blur taps, TV / BTV windows) hit shared memory, L1 or L2. At the
// paths' shapes that byte bound is 3-20 us; the 16-frame BTV tile is bound by
// its operations instead. Nothing here is a matrix product, so the tensor
// cores do not apply: the work runs on the FP32 / FP64 and integer pipes and
// on shared memory. The residual kernel and the data, TV and 3D TV modes of
// the gradient kernel are instruction-bound as written: each thread divides
// and takes remainders by the run-time scale s in its tap loops and rebuilds
// every frame's bilinear taps in float64. The BTV mode has a kernel of its
// own, laid out for this card (sr_btv_gradient_kernel, with its note).

#include <cuda_runtime.h>
#include <stddef.h>

namespace {

constexpr int BX = 32;        // block width  (fastest-varying image axis)
constexpr int BY = 8;         // block height
constexpr int NT = BX * BY;   // threads per block
constexpr int MAX_BTV_RANGE = 8;
// HR tile of one block of the BTV gradient kernel (threads stay BX x BY;
// each thread computes (BTV_TH / BY) x (BTV_TW / BX) pixels).
constexpr int BTV_TH = 16;
constexpr int BTV_TW = 32;
static_assert(BTV_TH % BY == 0 && BTV_TW % BX == 0, "the BTV tile must be whole thread blocks");
static_assert(BTV_TW >= MAX_BTV_RANGE && BTV_TH >= MAX_BTV_RANGE, "the BTV tile must cover the largest range");
constexpr int FRAME_CHUNK = 32;  // frames whose bilinear taps a BTV block stages at a time
constexpr int REDUCE_THREADS = 1024;

enum Mode { MODE_DATA = 0, MODE_TV = 1, MODE_BTV = 2, MODE_TV3D = 3 };

template <typename T>
__device__ __forceinline__ T sgn(T v) {
  return (T)((v > (T)0) - (v < (T)0));
}

template <typename T>
__device__ __forceinline__ T absval(T v) {
  return v < (T)0 ? -v : v;
}

// Non-negative remainder of a modulo s.
__device__ __forceinline__ int pmod(int a, int s) {
  int m = a % s;
  return m < 0 ? m + s : m;
}

// Where a launch's array lies in the image it is a part of: the global
// coordinates of its element (0, 0) and the global extent. The whole image
// is {0, 0, H, W}.
struct Tile {
  int u0, v0, Hg, Wg;
};

__device__ __forceinline__ bool in_image(const Tile& t, int r, int c) {
  const int gr = t.u0 + r, gc = t.v0 + c;
  return gr >= 0 && gr < t.Hg && gc >= 0 && gc < t.Wg;
}

// Bilinear taps of out(r, c) = in(r - dy, c - dx): tap (a, b) has weight
// w[2a + b] and reads in(r - (iy + a), c - (ix + b)).
template <typename T>
__device__ __forceinline__ void warp_taps(double dx, double dy, int& iy, int& ix, T w[4]) {
  double fly = floor(dy), flx = floor(dx);
  iy = (int)fly;
  ix = (int)flx;
  double fy = dy - fly, fx = dx - flx;
  w[0] = (T)((1.0 - fy) * (1.0 - fx));
  w[1] = (T)((1.0 - fy) * fx);
  w[2] = (T)(fy * (1.0 - fx));
  w[3] = (T)(fy * fx);
}

// Sum over the block; the result is valid in thread 0 only. Every thread of
// the block must call it.
__device__ __forceinline__ double block_sum(double v) {
  __shared__ double warp_sums[NT / 32];
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  int tid = threadIdx.y * BX + threadIdx.x;
  if ((tid & 31) == 0) warp_sums[tid >> 5] = v;
  __syncthreads();
  double total = 0.0;
  if (tid == 0) {
    for (int i = 0; i < NT / 32; ++i) total += warp_sums[i];
  }
  return total;
}

__device__ __forceinline__ int linear_block() {
  return (blockIdx.z * gridDim.y + blockIdx.y) * gridDim.x + blockIdx.x;
}

// ---------------------------------------------------------------------------
// Kernel 1: LR residual r_k = D B M_k x - y_k, one thread per (k, c, qr, qc).
// Forward half of the Pallas data-term mode (warp stage, blur stage, masked
// residual, squared-residual cost). Reads x through L1/L2 (up to 4 warp taps
// per blur tap), y once, writes r once: the bytes of x, y and r are its floor.
// ---------------------------------------------------------------------------
template <typename T, bool SHARD>
__global__ void __launch_bounds__(NT) sr_residual_kernel(
    const T* __restrict__ x, const T* __restrict__ y,
    const double* __restrict__ shifts, const T* __restrict__ blur, int kh, int kw,
    int C, int H, int W, int s, int h, int w,
    Tile where, const T* __restrict__ mask, int halo_band,
    T* __restrict__ r, double* __restrict__ partials) {
  // A whole image is its own tile: the compiler then folds every test in
  // the image's coordinates into the test on the array's bounds beside it.
  const Tile tile = SHARD ? where : Tile{0, 0, H, W};
  const int qc = blockIdx.x * BX + threadIdx.x;
  const int qr = blockIdx.y * BY + threadIdx.y;
  const int kc = blockIdx.z;
  const int k = kc / C, c = kc % C;
  double sq = 0.0;
  if (qr < h && qc < w) {
    const size_t idx = ((size_t)kc * h + qr) * w + qc;
    // The LR pixels this launch answers for: the mask's, else those inside
    // the global image (the origin is a multiple of s, so the division is
    // exact); never the read-only halo band.
    bool owned = !(halo_band && c == C - 1);
    if (SHARD && owned && mask == nullptr) {
      const int gr = tile.u0 / s + qr, gc = tile.v0 / s + qc;
      owned = gr >= 0 && gr < tile.Hg / s && gc >= 0 && gc < tile.Wg / s;
    }
    T res = (T)0;
    if (owned) {
      int iy, ix;
      T wt[4];
      warp_taps<T>(shifts[2 * k], shifts[2 * k + 1], iy, ix, wt);
      const T* xc = x + (size_t)c * H * W;
      const int ar = kh / 2, ac = kw / 2;
      T z = (T)0;
      for (int i = 0; i < kh; ++i) {
        const int pr = s * qr + i - ar;
        const int gpr = tile.u0 + pr;
        if (gpr < 0 || gpr >= tile.Hg) continue;  // warp output is zero outside the image
        for (int j = 0; j < kw; ++j) {
          const int pc = s * qc + j - ac;
          const int gpc = tile.v0 + pc;
          if (gpc < 0 || gpc >= tile.Wg) continue;
          T val = (T)0;
#pragma unroll
          for (int a = 0; a < 2; ++a) {
            const int rr = pr - iy - a;
            if (rr < 0 || rr >= H) continue;  // beyond the array
#pragma unroll
            for (int b = 0; b < 2; ++b) {
              const T wgt = wt[2 * a + b];
              const int cc = pc - ix - b;
              if (wgt == (T)0 || cc < 0 || cc >= W) continue;
              if (SHARD && !in_image(tile, rr, cc)) continue;  // a source outside the image is zero
              val += wgt * xc[(size_t)rr * W + cc];
            }
          }
          const T tap = blur ? blur[i * kw + j] : (T)1;
          z += tap * val;
        }
      }
      res = z - y[idx];
      if (SHARD && mask != nullptr) res *= mask[(size_t)qr * w + qc];
    }
    r[idx] = res;
    sq = (double)res * (double)res;
  }
  const double total = block_sum(sq);
  if (threadIdx.x == 0 && threadIdx.y == 0) partials[linear_block()] = total;
}

// ---------------------------------------------------------------------------
// Regulariser pieces, gather form.
// ---------------------------------------------------------------------------

// x at (rr, cc) of one channel, rr, cc >= 0. On a tile (SHARD) zero beyond
// the array; on a whole image the caller's border test has kept it inside.
template <typename T, bool SHARD>
__device__ __forceinline__ T at_or_zero(const T* xc, int H, int W, int rr, int cc) {
  if (SHARD && (rr >= H || cc >= W)) return (T)0;
  return xc[(size_t)rr * W + cc];
}

// TV residual pieces at pixel (rr, cc): forward differences, zero past the
// border of the image (global coordinates); x reads as zero beyond the array.
template <typename T, bool SHARD>
__device__ __forceinline__ void tv_diffs(const T* xc, int H, int W, const Tile& t, int rr, int cc,
                                         T& dx, T& dy) {
  const T x0 = xc[(size_t)rr * W + cc];
  dx = (t.v0 + cc + 1 < t.Wg) ? at_or_zero<T, SHARD>(xc, H, W, rr, cc + 1) - x0 : (T)0;
  dy = (t.u0 + rr + 1 < t.Hg) ? at_or_zero<T, SHARD>(xc, H, W, rr + 1, cc) - x0 : (T)0;
}

// 3D TV residual pieces at band c, pixel (rr, cc): the 2D pieces plus the
// forward difference to band c + 1, zero at the last band. Every site has
// its own dz: the left, upper and previous-band neighbours of a pixel each
// take theirs from their own position.
template <typename T, bool SHARD>
__device__ __forceinline__ void tv3d_diffs(const T* x, int C, int H, int W, const Tile& t, int c,
                                           int rr, int cc, T& dx, T& dy, T& dz) {
  const size_t plane = (size_t)H * W;
  const T* xc = x + (size_t)c * plane;
  tv_diffs<T, SHARD>(xc, H, W, t, rr, cc, dx, dy);
  const size_t at = (size_t)rr * W + cc;
  dz = (c + 1 < C) ? xc[plane + at] - xc[at] : (T)0;
}

// ---------------------------------------------------------------------------
// Kernel 2: gradient, one thread per HR pixel (c, u, v). Adjoint half of the
// Pallas data-term mode (transposed blur of r, reverse warp, 2 s^2 scale)
// plus, by MODE, the fused 2D TV or the fused 3D spectral TV (the TV mode's
// `tv_use_3d`); the BTV mode is kernel 2b. Reads r (a 1/s^2
// image per frame, L2-resident), x and the constants, writes grad once:
// the bytes of x, constants and grad are its floor. It is where an
// evaluation's time goes (see the note on the bound at the top).
//   grad = 2 s^2 sum_k M_k^T B^T D^T r_k  (+ TV gradient),
// and the thread's own regulariser cost c r^2 into a per-block partial.
// ---------------------------------------------------------------------------
template <typename T, int MODE, bool SHARD>
__global__ void __launch_bounds__(NT) sr_gradient_kernel(
    const T* __restrict__ x, const T* __restrict__ r,
    const double* __restrict__ shifts, const T* __restrict__ blur, int kh, int kw,
    int K, int C, int H, int W, int s, int h, int w, Tile where,
    const T* __restrict__ constants, T* __restrict__ grad, double* __restrict__ partials) {
  const Tile tile = SHARD ? where : Tile{0, 0, H, W};  // see sr_residual_kernel
  const int v = blockIdx.x * BX + threadIdx.x;
  const int u = blockIdx.y * BY + threadIdx.y;
  const int c = blockIdx.z;
  double reg_cost = 0.0;
  if (u < H && v < W) {
    // kernel^T has kw rows and kh columns: kT[i][j] = blur[j][i].
    const int ar = kw / 2, ac = kh / 2;
    T acc = (T)0;
    for (int k = 0; k < K; ++k) {
      int iy, ix;
      T wt[4];
      warp_taps<T>(-shifts[2 * k], -shifts[2 * k + 1], iy, ix, wt);
      const T* rk = r + ((size_t)k * C + c) * h * w;
      T gk = (T)0;
#pragma unroll
      for (int a = 0; a < 2; ++a) {
        // B^T D^T r is zero outside the image (global coordinates); beyond
        // the array it is made of the residuals there are, none being zero.
        const int pr = u - iy - a;
        const int gpr = tile.u0 + pr;
        if (gpr < 0 || gpr >= tile.Hg) continue;
#pragma unroll
        for (int b = 0; b < 2; ++b) {
          const T wgt = wt[2 * a + b];
          const int pc = v - ix - b;
          const int gpc = tile.v0 + pc;
          if (wgt == (T)0 || gpc < 0 || gpc >= tile.Wg) continue;
          // g1(pr, pc) = sum_ij kT[i][j] up(r_k)(pr + i - ar, pc + j - ac):
          // only taps landing on a multiple of s hit an LR sample.
          T g1 = (T)0;
          for (int i = pmod(ar - pr, s); i < kw; i += s) {
            const int tr = pr + i - ar;
            if (tr < 0) continue;
            const int lr = tr / s;
            if (lr >= h) break;
            for (int j = pmod(ac - pc, s); j < kh; j += s) {
              const int tc = pc + j - ac;
              if (tc < 0) continue;
              const int lc = tc / s;
              if (lc >= w) break;
              const T tap = blur ? blur[j * kw + i] : (T)1;
              g1 += tap * rk[(size_t)lr * w + lc];
            }
          }
          gk += wgt * g1;
        }
      }
      acc += gk;
    }
    T out = (T)(2.0 * (double)s * (double)s) * acc;

    const size_t base = (size_t)c * H * W;
    const size_t idx = base + (size_t)u * W + v;
    const T* xc = x + base;
    if constexpr (MODE == MODE_TV) {
      const T* cc = constants + base;
      T dx0, dy0;
      tv_diffs<T, SHARD>(xc, H, W, tile, u, v, dx0, dy0);
      const T c0 = cc[(size_t)u * W + v];
      const T r0 = absval(dx0) + absval(dy0);
      const T g0 = ((T)2 * c0) * r0;
      T tv = -g0 * (sgn(dx0) + sgn(dy0));
      if (v > 0) {  // gx of the left neighbour
        T dxl, dyl;
        tv_diffs<T, SHARD>(xc, H, W, tile, u, v - 1, dxl, dyl);
        const T gl = ((T)2 * cc[(size_t)u * W + v - 1]) * (absval(dxl) + absval(dyl));
        tv += gl * sgn(dxl);
      }
      if (u > 0) {  // gy of the upper neighbour
        T dxu, dyu;
        tv_diffs<T, SHARD>(xc, H, W, tile, u - 1, v, dxu, dyu);
        const T gu = ((T)2 * cc[(size_t)(u - 1) * W + v]) * (absval(dxu) + absval(dyu));
        tv += gu * sgn(dyu);
      }
      out += tv;
      reg_cost = (double)((c0 * r0) * r0);
    } else if constexpr (MODE == MODE_TV3D) {
      // G = 2 c r at four sites: this pixel, its left and upper neighbours
      // and the same pixel one band down, each with r = |dx| + |dy| + |dz|
      // taken at that site. In the plain version's order: the 2D terms,
      // then -G s_z here, then +G s_z of band c - 1 (nothing flows into band 0).
      const size_t plane = (size_t)H * W;
      const T* cc = constants + base;
      T dx0, dy0, dz0;
      tv3d_diffs<T, SHARD>(x, C, H, W, tile, c, u, v, dx0, dy0, dz0);
      const T c0 = cc[(size_t)u * W + v];
      const T r0 = absval(dx0) + absval(dy0) + absval(dz0);
      const T g0 = ((T)2 * c0) * r0;
      T tv = -g0 * (sgn(dx0) + sgn(dy0));
      if (v > 0) {
        T dxl, dyl, dzl;
        tv3d_diffs<T, SHARD>(x, C, H, W, tile, c, u, v - 1, dxl, dyl, dzl);
        const T gl =
            ((T)2 * cc[(size_t)u * W + v - 1]) * (absval(dxl) + absval(dyl) + absval(dzl));
        tv += gl * sgn(dxl);
      }
      if (u > 0) {
        T dxu, dyu, dzu;
        tv3d_diffs<T, SHARD>(x, C, H, W, tile, c, u - 1, v, dxu, dyu, dzu);
        const T gu =
            ((T)2 * cc[(size_t)(u - 1) * W + v]) * (absval(dxu) + absval(dyu) + absval(dzu));
        tv += gu * sgn(dyu);
      }
      tv -= g0 * sgn(dz0);
      if (c > 0) {
        T dxp, dyp, dzp;
        tv3d_diffs<T, SHARD>(x, C, H, W, tile, c - 1, u, v, dxp, dyp, dzp);
        const T gp = ((T)2 * (cc - plane)[(size_t)u * W + v]) *
                     (absval(dxp) + absval(dyp) + absval(dzp));
        tv += gp * sgn(dzp);
      }
      out += tv;
      reg_cost = (double)((c0 * r0) * r0);
    }
    grad[idx] = out;
  }
  if constexpr (MODE != MODE_DATA) {
    const double total = block_sum(reg_cost);
    if (threadIdx.x == 0 && threadIdx.y == 0) partials[linear_block()] = total;
  }
}

// ---------------------------------------------------------------------------
// Kernel 2b: gradient with the fused BTV term, one block per BTV_TH x BTV_TW
// HR tile of one channel. Replaces the Pallas kernel's BTV region
// (degrade.py:1405-1607) and, fused into the same launch, the adjoint half of
// its data-term mode (degrade.py:1111-1254); it computes what kernel 2 computed
// in its BTV mode, for every P in 1..MAX_BTV_RANGE, decay, s, shift and tile.
//
// What bounds it: its floor is bytes (x, the constants and grad once, each
// frame's r about once), but a gather thread that works alone is bound by
// instructions: (P+1)^2 - 1 window terms for its own residual and again for
// each of its P^2 - 1 overlap sources, and, per frame, float64 taps and a
// walk over the blur taps that land on an LR sample for each of its four
// bilinear reads. The design does each of those once per block:
//  1. x is staged in shared memory over the tile, P - 1 up-left and P
//     down-right, zero beyond the array (as at_or_zero reads it); every
//     window read is then a shared-memory read.
//  2. G = 2 c r is computed once per position, over the tile and an up-left
//     margin of P - 1 (the sources of the tile's overlap terms), and kept in
//     shared memory, as the Pallas kernel keeps G over its tile and margin.
//     r keeps its inclusive window, cut at the image's border; the tile's
//     own c r^2 goes into the block's cost. Each thread then adds its own
//     terms a^(i+j) G(p) sign(D_ij(p)) and subtracts the overlap terms
//     a^(i+j) G(q) sign(x(q) - x(p)), q = p - (i, j), read from the G map. A
//     source outside the array has G = 0; the image's pixel (0, 0) is no
//     source, so its G is zeroed once the own terms have read it. A block
//     whose reach lies inside the image runs the window loops without border
//     tests (a branch that is the same for the whole block).
//  3. P is a template parameter, so the loops unroll to exactly the window;
//     the decay powers are made on the host in double, rounded once to T, and
//     passed as a kernel parameter that is read at constant indices. No array
//     is indexed at run time: no local memory (chip_smoke.py checks 0 bytes
//     for every one). With P at run time instead (loops unrolled to
//     MAX_BTV_RANGE, leaving at P; shared pitches for the largest range) the
//     kernel was 11-22 % slower on the paths' rows and built hardly faster.
//  4. The data-term adjoint is staged per frame: the bilinear taps of a frame
//     (float64, rounded once to T, as warp_taps makes them) are made once per
//     block; g1 = B^T D^T r_k is made once per position over the tile plus one
//     row and column, offset by the taps, into shared memory (two buffers,
//     one barrier per frame), zero outside the image, from the residuals that
//     exist beyond the array; each thread sums its four weighted reads in the
//     (a, b) order. s is a template parameter for s = 2 and 4 (shifts and
//     masks); S = 0 takes s at run time, for any other s.
//  5. Gather form: each output is written by one thread, no atomics, the cost
//     partial per block in double, summed by kernel 3 in block order.
// ---------------------------------------------------------------------------

// a[n] = decay^n for n <= 2 P: made in double on the host, rounded once to T.
template <typename T>
struct Powers {
  T a[2 * MAX_BTV_RANGE + 1];
};

// BTV residual at q from staged x (xq points at x(q), rows XW apart):
// inclusive window [0, P]^2; with CUT, offsets past the image's border
// (i > imax or j > jmax) are left out.
template <typename T, int P, int XW, bool CUT>
__device__ __forceinline__ T staged_btv_residual(const T* xq, int imax, int jmax,
                                                 const Powers<T>& pw) {
  const T x0 = xq[0];
  T rs = (T)0;
#pragma unroll
  for (int i = 0; i <= P; ++i) {
#pragma unroll
    for (int j = 0; j <= P; ++j) {
      if ((i == 0 && j == 0) || (CUT && (i > imax || j > jmax))) continue;
      rs += pw.a[i + j] * absval(x0 - xq[i * XW + j]);
    }
  }
  return rs;
}

// BTV gradient at p from staged x (xp at x(p), rows XW apart) and the G map
// (gp at G(p), rows GW apart; G(p) itself is g0): gradient window [0, P)^2,
// own term where the offset stays inside the image (CUT: i <= imax and
// j <= jmax), overlap term where p lies in the source's window (in_window).
template <typename T, int P, int XW, int GW, bool CUT>
__device__ __forceinline__ T staged_btv_gradient(const T* xp, const T* gp, T g0, int imax,
                                                 int jmax, bool in_window, const Powers<T>& pw) {
  const T x0 = xp[0];
  T btv = (T)0;
#pragma unroll
  for (int i = 0; i < P; ++i) {
#pragma unroll
    for (int j = 0; j < P; ++j) {
      if (i == 0 && j == 0) continue;
      if (!CUT || (i <= imax && j <= jmax)) btv += (pw.a[i + j] * g0) * sgn(x0 - xp[i * XW + j]);
      if (in_window) btv -= (pw.a[i + j] * gp[-(i * GW + j)]) * sgn(xp[-(i * XW + j)] - x0);
    }
  }
  return btv;
}

// g1(pr, pc) = (B^T D^T r_k)(pr, pc): zero outside the image (global
// coordinates); only the kernel^T taps that land on a multiple of s hit an
// LR sample, and beyond the array it is made of the residuals there are.
// Inlined into a kernel whose s is a compile-time constant, the remainders
// and divisions by s fold to shifts and masks.
template <typename T>
__device__ __forceinline__ T adjoint_sample(const T* rk, const T* blur, int kh, int kw, int s,
                                            int h, int w, const Tile& t, int pr, int pc) {
  const int gpr = t.u0 + pr, gpc = t.v0 + pc;
  if (gpr < 0 || gpr >= t.Hg || gpc < 0 || gpc >= t.Wg) return (T)0;
  const int ar = kw / 2, ac = kh / 2;  // kernel^T has kw rows and kh columns
  T g1 = (T)0;
  for (int i = pmod(ar - pr, s); i < kw; i += s) {
    const int tr = pr + i - ar;
    if (tr < 0) continue;
    const int lr = tr / s;
    if (lr >= h) break;
    for (int j = pmod(ac - pc, s); j < kh; j += s) {
      const int tc = pc + j - ac;
      if (tc < 0) continue;
      const int lc = tc / s;
      if (lc >= w) break;
      const T tap = blur ? blur[j * kw + i] : (T)1;
      g1 += tap * rk[(size_t)lr * w + lc];
    }
  }
  return g1;
}

// Blocks of the BTV kernel that one SM must hold at once. Given with the
// block size, it sets the registers ptxas may use, 65536 / (NT x blocks),
// and keeps it from spilling to reach a higher occupancy, which it does with
// the block size alone (0 bytes of local memory is a requirement, see 3.).
// Larger P and double need more registers.
template <typename T, int P>
constexpr int btv_min_blocks() {
  return sizeof(T) == 8 ? (P <= 3 ? 3 : 2) : (P <= 3 ? 4 : 3);
}

template <typename T, int P, int S, bool SHARD>
__global__ void __launch_bounds__(NT, (btv_min_blocks<T, P>())) sr_btv_gradient_kernel(
    const T* __restrict__ x, const T* __restrict__ r,
    const double* __restrict__ shifts, const T* __restrict__ blur, int kh, int kw,
    int K, int C, int H, int W, int s_arg, int h, int w, Tile where,
    const T* __restrict__ constants, Powers<T> pw,
    T* __restrict__ grad, double* __restrict__ partials) {
  constexpr int TH = BTV_TH, TW = BTV_TW, RY = TH / BY, RX = TW / BX;
  constexpr int M = P - 1;                       // up-left margin of the G map
  constexpr int XH = TH + M + P, XW = TW + M + P;  // staged x
  constexpr int GH = TH + M, GW = TW + M;          // G map
  static_assert(sizeof(T) * (XH * XW + GH * GW + 2 * (TH + 1) * (TW + 1) + 4 * FRAME_CHUNK) +
                        2 * sizeof(int) * FRAME_CHUNK <= 48 * 1024,
                "the BTV kernel's static shared memory exceeds 48 KB");
  __shared__ T xs[XH][XW];
  __shared__ T gs[GH][GW];
  __shared__ T g1s[2][TH + 1][TW + 1];
  __shared__ int tap_y[FRAME_CHUNK], tap_x[FRAME_CHUNK];
  __shared__ T tap_w[FRAME_CHUNK][4];

  const int s = S > 0 ? S : s_arg;
  const Tile tile = SHARD ? where : Tile{0, 0, H, W};  // see sr_residual_kernel
  const int tx = threadIdx.x, ty = threadIdx.y, tid = ty * BX + tx;
  const int c = blockIdx.z;
  const int R0 = blockIdx.y * TH, C0 = blockIdx.x * TW;
  const size_t base = (size_t)c * H * W;
  const T* xc = x + base;
  const T* cc = constants + base;

  // 1. x over the tile and its reach, zero beyond the array; the taps of the
  //    first frames.
  for (int i = tid; i < XH * XW; i += NT) {
    const int rr = R0 - M + i / XW, cl = C0 - M + i % XW;
    xs[i / XW][i % XW] = (rr >= 0 && rr < H && cl >= 0 && cl < W) ? xc[(size_t)rr * W + cl] : (T)0;
  }
  auto stage_taps = [&](int k0) {
    const int k = k0 + tid;
    if (tid < FRAME_CHUNK && k < K) {
      int iy, ix;
      T wt[4];
      warp_taps<T>(-shifts[2 * k], -shifts[2 * k + 1], iy, ix, wt);
      tap_y[tid] = iy;
      tap_x[tid] = ix;
#pragma unroll
      for (int q = 0; q < 4; ++q) tap_w[tid][q] = wt[q];
    }
  };
  stage_taps(0);
  __syncthreads();

  // 2. 2 s^2 sum_k M_k^T B^T D^T r_k, one frame at a time.
  T acc[RY][RX];
#pragma unroll
  for (int a = 0; a < RY; ++a)
#pragma unroll
    for (int b = 0; b < RX; ++b) acc[a][b] = (T)0;
  for (int k0 = 0; k0 < K; k0 += FRAME_CHUNK) {
    if (k0 > 0) {  // the previous frames' taps are read no more
      __syncthreads();
      stage_taps(k0);
      __syncthreads();
    }
    const int nk = K - k0 < FRAME_CHUNK ? K - k0 : FRAME_CHUNK;
    for (int kk = 0; kk < nk; ++kk) {
      const int k = k0 + kk;
      const int iy = tap_y[kk], ix = tap_x[kk];
      const T* rk = r + ((size_t)k * C + c) * h * w;
      T(*g1)[TW + 1] = g1s[k & 1];
      // g1 over the rows and columns this tile's bilinear taps read:
      // g1[yy][xx] = g1(R0 - iy - 1 + yy, C0 - ix - 1 + xx).
      for (int i = tid; i < (TH + 1) * (TW + 1); i += NT) {
        const int yy = i / (TW + 1), xx = i % (TW + 1);
        g1[yy][xx] = adjoint_sample<T>(rk, blur, kh, kw, s, h, w, tile, R0 - iy - 1 + yy,
                                       C0 - ix - 1 + xx);
      }
      __syncthreads();
      const T w0 = tap_w[kk][0], w1 = tap_w[kk][1], w2 = tap_w[kk][2], w3 = tap_w[kk][3];
#pragma unroll
      for (int a = 0; a < RY; ++a) {
#pragma unroll
        for (int b = 0; b < RX; ++b) {
          const int ly = ty + a * BY, lx = tx + b * BX;
          // Tap (a', b') reads g1(u - iy - a', v - ix - b') = g1[ly + 1 - a'][lx + 1 - b'].
          T gk = (T)0;
          gk += w0 * g1[ly + 1][lx + 1];
          gk += w1 * g1[ly + 1][lx];
          gk += w2 * g1[ly][lx + 1];
          gk += w3 * g1[ly][lx];
          acc[a][b] += gk;
        }
      }
    }
  }

  // 3. The G map over the tile and its up-left margin; the tile's c r^2.
  const int gr0 = tile.u0 + R0 - M, gc0 = tile.v0 + C0 - M;  // image coordinates of gs[0][0]
  const bool interior = gr0 + GH - 1 + P < tile.Hg && gc0 + GW - 1 + P < tile.Wg;
  double reg_cost = 0.0;
  for (int i = tid; i < GH * GW; i += NT) {
    const int gy = i / GW, gx = i % GW;
    const int qr = R0 - M + gy, qc = C0 - M + gx;
    T g = (T)0;
    if (qr >= 0 && qr < H && qc >= 0 && qc < W) {
      const T* xq = &xs[gy][gx];
      const T rq = interior ? staged_btv_residual<T, P, XW, false>(xq, P, P, pw)
                            : staged_btv_residual<T, P, XW, true>(
                                  xq, tile.Hg - 1 - (gr0 + gy), tile.Wg - 1 - (gc0 + gx), pw);
      const T cq = cc[(size_t)qr * W + qc];
      g = ((T)2 * cq) * rq;
      if (gy >= M && gx >= M) reg_cost += (double)((cq * rq) * rq);
    }
    gs[gy][gx] = g;
  }
  __syncthreads();

  // 4. The BTV gradient of this thread's pixels, added to the data term's.
  T g_own[RY][RX];
#pragma unroll
  for (int a = 0; a < RY; ++a)
#pragma unroll
    for (int b = 0; b < RX; ++b) g_own[a][b] = gs[M + ty + a * BY][M + tx + b * BX];
  const int oy = -gr0, ox = -gc0;  // the image's pixel (0, 0) in the G map
  if (oy >= 0 && oy < GH && ox >= 0 && ox < GW) {  // the same for the whole block
    __syncthreads();
    if (tid == 0) gs[oy][ox] = (T)0;
    __syncthreads();
  }
  const T scale2 = (T)(2.0 * (double)s * (double)s);
#pragma unroll
  for (int a = 0; a < RY; ++a) {
#pragma unroll
    for (int b = 0; b < RX; ++b) {
      const int ly = ty + a * BY, lx = tx + b * BX;
      const int imax = tile.Hg - 1 - (tile.u0 + R0 + ly), jmax = tile.Wg - 1 - (tile.v0 + C0 + lx);
      const bool in_window = !SHARD || (imax >= 0 && jmax >= 0);
      const T* xp = &xs[M + ly][M + lx];
      const T* gp = &gs[M + ly][M + lx];
      const T btv = interior
                        ? staged_btv_gradient<T, P, XW, GW, false>(xp, gp, g_own[a][b], P, P, in_window, pw)
                        : staged_btv_gradient<T, P, XW, GW, true>(xp, gp, g_own[a][b], imax, jmax,
                                                                  in_window, pw);
      const int u = R0 + ly, v = C0 + lx;
      if (u < H && v < W) grad[base + (size_t)u * W + v] = scale2 * acc[a][b] + btv;
    }
  }
  const double total = block_sum(reg_cost);
  if (tid == 0) partials[linear_block()] = total;
}

// ---------------------------------------------------------------------------
// Kernel 3: cost = data_scale * sum(data partials) + sum(reg partials): the sum
// over per-tile cost partials that the Pallas wrapper returns with its call.
// One block; each thread sums a strided slice in index order, then a tree.
// ---------------------------------------------------------------------------
template <typename T>
__global__ void __launch_bounds__(REDUCE_THREADS) sr_reduce_kernel(
    const double* __restrict__ partials, int n_data, int n_reg, double data_scale,
    T* __restrict__ cost) {
  __shared__ double sh_data[REDUCE_THREADS];
  __shared__ double sh_reg[REDUCE_THREADS];
  const int tid = threadIdx.x;
  double a = 0.0, b = 0.0;
  for (int i = tid; i < n_data; i += REDUCE_THREADS) a += partials[i];
  for (int i = tid; i < n_reg; i += REDUCE_THREADS) b += partials[n_data + i];
  sh_data[tid] = a;
  sh_reg[tid] = b;
  __syncthreads();
  for (int stride = REDUCE_THREADS / 2; stride > 0; stride >>= 1) {
    if (tid < stride) {
      sh_data[tid] += sh_data[tid + stride];
      sh_reg[tid] += sh_reg[tid + stride];
    }
    __syncthreads();
  }
  if (tid == 0) cost[0] = (T)(data_scale * sh_data[0] + sh_reg[0]);
}

inline int ceil_div(int a, int b) { return (a + b - 1) / b; }

inline bool is_whole_image(const Tile& t, int H, int W) {
  return t.u0 == 0 && t.v0 == 0 && t.Hg == H && t.Wg == W;
}

template <typename T>
int launch_residual(const void* x, const void* y, const double* shifts, const void* blur,
                    int kh, int kw, int K, int C, int H, int W, int s, Tile tile,
                    const void* mask, int halo_band, void* r, double* partials,
                    cudaStream_t stream) {
  const int h = H / s, w = W / s;
  dim3 block(BX, BY), grid(ceil_div(w, BX), ceil_div(h, BY), K * C);
  if (is_whole_image(tile, H, W) && mask == nullptr) {
    sr_residual_kernel<T, false><<<grid, block, 0, stream>>>(
        (const T*)x, (const T*)y, shifts, (const T*)blur, kh, kw, C, H, W, s, h, w, tile,
        nullptr, halo_band, (T*)r, partials);
  } else {
    sr_residual_kernel<T, true><<<grid, block, 0, stream>>>(
        (const T*)x, (const T*)y, shifts, (const T*)blur, kh, kw, C, H, W, s, h, w, tile,
        (const T*)mask, halo_band, (T*)r, partials);
  }
  return (int)cudaGetLastError();
}

// The BTV gradient kernel for a range, scale and kind of array: one
// instantiation per P in 1..MAX_BTV_RANGE, s in {2, 4, any other} and tile
// or whole image. nullptr for a P out of range.
template <typename T>
using BtvKernel = void (*)(const T*, const T*, const double*, const T*, int, int, int, int, int,
                           int, int, int, int, Tile, const T*, Powers<T>, T*, double*);

template <typename T, int P, bool SHARD>
BtvKernel<T> btv_kernel_for_scale(int s) {
  if (s == 2) return sr_btv_gradient_kernel<T, P, 2, SHARD>;
  if (s == 4) return sr_btv_gradient_kernel<T, P, 4, SHARD>;
  return sr_btv_gradient_kernel<T, P, 0, SHARD>;
}

template <typename T, bool SHARD>
BtvKernel<T> btv_kernel_for_range(int P, int s) {
  switch (P) {
    case 1: return btv_kernel_for_scale<T, 1, SHARD>(s);
    case 2: return btv_kernel_for_scale<T, 2, SHARD>(s);
    case 3: return btv_kernel_for_scale<T, 3, SHARD>(s);
    case 4: return btv_kernel_for_scale<T, 4, SHARD>(s);
    case 5: return btv_kernel_for_scale<T, 5, SHARD>(s);
    case 6: return btv_kernel_for_scale<T, 6, SHARD>(s);
    case 7: return btv_kernel_for_scale<T, 7, SHARD>(s);
    case 8: return btv_kernel_for_scale<T, 8, SHARD>(s);
    default: return nullptr;
  }
}
static_assert(MAX_BTV_RANGE == 8, "btv_kernel_for_range instantiates P = 1..8");

template <typename T>
BtvKernel<T> btv_kernel(int P, int s, bool shard) {
  return shard ? btv_kernel_for_range<T, true>(P, s) : btv_kernel_for_range<T, false>(P, s);
}

template <typename T>
int launch_gradient(const void* x, const void* r, const double* shifts, const void* blur,
                    int kh, int kw, int K, int C, int H, int W, int s, Tile tile, int mode,
                    const void* constants, int P, double decay, void* grad,
                    double* partials, cudaStream_t stream) {
  const int h = H / s, w = W / s;
  dim3 block(BX, BY);
  const bool whole = is_whole_image(tile, H, W);
  if (mode == MODE_BTV) {
    Powers<T> pw{};
    double p = 1.0;
    for (int n = 0; n <= 2 * P; ++n) {
      pw.a[n] = (T)p;
      p *= decay;
    }
    dim3 grid(ceil_div(W, BTV_TW), ceil_div(H, BTV_TH), C);
    const BtvKernel<T> kernel = btv_kernel<T>(P, s, !whole);
    kernel<<<grid, block, 0, stream>>>(
        (const T*)x, (const T*)r, shifts, (const T*)blur, kh, kw, K, C, H, W, s, h, w, tile,
        (const T*)constants, pw, (T*)grad, partials);
    return (int)cudaGetLastError();
  }
  dim3 grid(ceil_div(W, BX), ceil_div(H, BY), C);
#define SR_LAUNCH_AS(M, SHARD)                                                             \
  sr_gradient_kernel<T, M, SHARD><<<grid, block, 0, stream>>>(                             \
      (const T*)x, (const T*)r, shifts, (const T*)blur, kh, kw, K, C, H, W, s, h, w, tile, \
      (const T*)constants, (T*)grad, partials)
#define SR_LAUNCH(M)         \
  if (whole) {               \
    SR_LAUNCH_AS(M, false);  \
  } else {                   \
    SR_LAUNCH_AS(M, true);   \
  }
  if (mode == MODE_DATA) {
    SR_LAUNCH(MODE_DATA);
  } else if (mode == MODE_TV) {
    SR_LAUNCH(MODE_TV);
  } else {
    SR_LAUNCH(MODE_TV3D);
  }
#undef SR_LAUNCH
#undef SR_LAUNCH_AS
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C interface. Every pointer is a device pointer, except `tile` (four
// ints on the host, read before the launch); `stream` is a cudaStream_t. Each launcher returns cudaGetLastError() (0 = success) or a
// negative code for an argument it refuses.
extern "C" {

// Number of per-block cost partials each kernel writes for a problem size.
int sr_residual_blocks(int K, int C, int H, int W, int s) {
  return ceil_div(W / s, BX) * ceil_div(H / s, BY) * K * C;
}

// The data mode writes none; the BTV kernel's blocks are tiles of BTV_TH x BTV_TW.
int sr_gradient_blocks(int mode, int C, int H, int W) {
  if (mode == MODE_DATA) return 0;
  if (mode == MODE_BTV) return ceil_div(W, BTV_TW) * ceil_div(H, BTV_TH) * C;
  return ceil_div(W, BX) * ceil_div(H, BY) * C;
}

int sr_max_btv_range() { return MAX_BTV_RANGE; }

// What the compiler gave the BTV gradient kernel for range P, scale s (2 and
// 4 have their own instantiations, any other s shares one) and a tile
// (shard != 0) or whole image: out = {registers per thread, local memory
// bytes per thread, static shared memory bytes per block, max threads per
// block}. Returns the cudaError_t of cudaFuncGetAttributes, or -5 for a P
// out of range.
int sr_btv_kernel_attributes(int btv_range, int s, int shard, int is_double, int* out) {
  const void* fn = is_double ? (const void*)btv_kernel<double>(btv_range, s, shard != 0)
                             : (const void*)btv_kernel<float>(btv_range, s, shard != 0);
  if (fn == nullptr) return -5;
  cudaFuncAttributes attr;
  const cudaError_t err = cudaFuncGetAttributes(&attr, fn);
  if (err != cudaSuccess) return (int)err;
  out[0] = attr.numRegs;
  out[1] = (int)attr.localSizeBytes;
  out[2] = (int)attr.sharedSizeBytes;
  out[3] = attr.maxThreadsPerBlock;
  return 0;
}

// `tile` = {u0, v0, Hg, Wg}: where the [C, H, W] array lies in the image it
// is a tile of ({0, 0, H, W} for a whole image). Refused unless the origin
// is a multiple of s and the global extent a positive multiple of s.
static int check_tile(const int* tile, int s) {
  if (tile == nullptr) return -6;
  if (tile[0] % s != 0 || tile[1] % s != 0) return -7;
  if (tile[2] < s || tile[3] < s || tile[2] % s != 0 || tile[3] % s != 0) return -8;
  return 0;
}

// `mask`: nullable [H/s, W/s] of 0/1 in x's type, the LR pixels whose
// residual counts. `halo_band` != 0: channel C - 1 is a read-only spectral
// halo (needs C >= 2).
int sr_data_residual(const void* x, const void* y, const double* shifts, const void* blur,
                     int kh, int kw, int K, int C, int H, int W, int s, const int* tile,
                     const void* mask, int halo_band, void* r, double* partials, int is_double,
                     void* stream) {
  if (s < 1 || H % s != 0 || W % s != 0 || kh < 1 || kw < 1 || K < 1 || C < 1) return -1;
  if ((long long)K * C > 65535 || C > 65535) return -2;
  if (int bad = check_tile(tile, s)) return bad;
  if (halo_band && C < 2) return -9;
  const Tile t{tile[0], tile[1], tile[2], tile[3]};
  cudaStream_t st = (cudaStream_t)stream;
  return is_double ? launch_residual<double>(x, y, shifts, blur, kh, kw, K, C, H, W, s, t, mask,
                                             halo_band, r, partials, st)
                   : launch_residual<float>(x, y, shifts, blur, kh, kw, K, C, H, W, s, t, mask,
                                            halo_band, r, partials, st);
}

int sr_objective_gradient(const void* x, const void* r, const double* shifts, const void* blur,
                          int kh, int kw, int K, int C, int H, int W, int s, const int* tile,
                          int mode, const void* constants, int btv_range, double btv_decay,
                          void* grad, double* reg_partials, int is_double, void* stream) {
  if (s < 1 || H % s != 0 || W % s != 0 || kh < 1 || kw < 1 || K < 1 || C < 1) return -1;
  if (C > 65535) return -2;
  if (mode < MODE_DATA || mode > MODE_TV3D) return -3;
  if (mode != MODE_DATA && constants == nullptr) return -4;
  if (mode == MODE_BTV && (btv_range < 1 || btv_range > MAX_BTV_RANGE)) return -5;
  if (int bad = check_tile(tile, s)) return bad;
  const Tile t{tile[0], tile[1], tile[2], tile[3]};
  cudaStream_t st = (cudaStream_t)stream;
  return is_double ? launch_gradient<double>(x, r, shifts, blur, kh, kw, K, C, H, W, s, t, mode,
                                             constants, btv_range, btv_decay, grad,
                                             reg_partials, st)
                   : launch_gradient<float>(x, r, shifts, blur, kh, kw, K, C, H, W, s, t, mode,
                                            constants, btv_range, btv_decay, grad,
                                            reg_partials, st);
}

int sr_reduce_cost(const double* partials, int n_data, int n_reg, double data_scale, void* cost,
                   int is_double, void* stream) {
  if (n_data < 0 || n_reg < 0) return -1;
  cudaStream_t st = (cudaStream_t)stream;
  if (is_double) {
    sr_reduce_kernel<double><<<1, REDUCE_THREADS, 0, st>>>(partials, n_data, n_reg, data_scale,
                                                        (double*)cost);
  } else {
    sr_reduce_kernel<float><<<1, REDUCE_THREADS, 0, st>>>(partials, n_data, n_reg, data_scale,
                                                       (float*)cost);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
