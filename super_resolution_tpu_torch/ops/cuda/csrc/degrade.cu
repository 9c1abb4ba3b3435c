// Hand-written Hopper (sm_90a) kernels for the fused MAP objective.
//
// Together the kernels below replace every mode of the Pallas TPU kernel
// `pallas_data_term_cost_and_grad`
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
// axis runs over the channels, so tens or hundreds of bands need no blocking
// argument -- the TPU blocked them to fit VMEM.
//
// The TPU kernel splits x into s*s polyphase planes and pre-extracts
// overlapping windows because its toolchain rejects strided and runtime
// slices. None of that is carried over: the kernels index the [C, H, W]
// image as it lies in memory, stage what a block reads in shared memory, and
// take the motion shifts as runtime data.
//
// Everything is in gather form: each thread owns its output elements and
// reads whatever it needs. No float atomics, so results are identical from
// run to run. Cost partials are accumulated in double, one per block, and
// summed in block order by a one-block kernel.
//
// Semantics that must not be "simplified" (each mirrors the reference):
//  * the warp output is zero outside the image BEFORE the blur reads it, and
//    the blurred-back residual is zero outside the image before the reverse
//    warp reads it (two-stage form). Merging warp and blur taps into one
//    composite table is exact only where neither zeroing can act; the
//    kernels use the composite there and the two-stage form in the band
//    along the image's border, chosen per output element;
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
// on shared memory. Each kernel's note says what its design does about the
// instructions and the latency that stand between it and that bound.

#include <cuda_runtime.h>
#include <limits.h>
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
// Composite tap tables of the residual and gradient kernels: a block holds
// those of up to COMPOSITE_FRAMES frames at a time, (kh+1)(kw+1) values each,
// in a table of TAP_TABLE values; a blur larger than 31 x 31 is refused.
constexpr int COMPOSITE_FRAMES = 64;
constexpr int TAP_TABLE = 1024;
// Rows and columns by which the residual kernel's staged rectangle of x may
// grow over one frame's footprint, so that it holds the footprints of all
// frames (their integer shifts spread by at most this much) and is staged once.
constexpr int FRAME_SPREAD = 8;
// HR rows of the gradient kernel's tile (of BX columns; rows / BY pixels a
// thread): more work per block for the tables and barriers it pays once,
// and more loads in flight per thread; half as many for double, whose staged
// TV inputs would not fit the 48 KB of static shared memory.
template <typename T>
__host__ __device__ constexpr int grad_tile_rows() {
  return sizeof(T) == 8 ? 2 * BY : 4 * BY;
}

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

// pmod for a scale S known at compile time (a power of two: a mask), or s.
template <int S>
__device__ __forceinline__ int phase(int a, int s) {
  static_assert(S == 0 || (S & (S - 1)) == 0, "compile-time scales are powers of two");
  return S > 0 ? (a & (S - 1)) : pmod(a, s);
}

// Where a launch's array lies in the image it is a part of: the global
// coordinates of its element (0, 0) and the global extent. The whole image
// is {0, 0, H, W}.
struct Tile {
  int u0, v0, Hg, Wg;
};

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

// x at (rr, cc) of one channel, rr, cc >= 0. On a tile (SHARD) zero beyond
// the array; on a whole image the caller's border test has kept it inside.
template <typename T, bool SHARD>
__device__ __forceinline__ T at_or_zero(const T* xc, int H, int W, int rr, int cc) {
  if (SHARD && (rr >= H || cc >= W)) return (T)0;
  return xc[(size_t)rr * W + cc];
}

// Rows [row0, row0 + nr) and columns [col0, col0 + nc) of one channel into
// shared memory (rows nc apart), a warp per row segment: zero beyond the
// array and outside the image (global coordinates).
template <typename T>
__device__ __forceinline__ void stage_rect(T* xs, const T* xc, int H, int W, const Tile& t, int row0,
                                           int col0, int nr, int nc) {
  for (int j = threadIdx.x; j < nc; j += BX) {
    const int cl = col0 + j;
    const bool col_in = cl >= 0 && cl < W && t.v0 + cl >= 0 && t.v0 + cl < t.Wg;
#pragma unroll 4
    for (int i = threadIdx.y; i < nr; i += BY) {  // unrolled: several loads in flight per thread
      const int rr = row0 + i;
      const bool in = col_in && rr >= 0 && rr < H && t.u0 + rr >= 0 && t.u0 + rr < t.Hg;
      xs[i * nc + j] = in ? xc[(size_t)rr * W + cl] : (T)0;
    }
  }
}

// The tables of frames k0 .. k0 + nk - 1, in float64 and rounded once to T.
// The bilinear taps of the warp by sign * (dx, dy) (as warp_taps makes them),
// and its composite with the blur: for the forward (ADJOINT false) the
// (kh+1) x (kw+1) table C[m][n] = sum_ab w_ab blur[m-1+a][n-1+b], so that
// (B M x)(p) = sum_mn C[m][n] x(p - (ar + iy + 1, ac + ix + 1) + (m, n)) where
// no border intervenes; for the adjoint the (kw+1) x (kh+1) table of the
// reverse warp with kernel^T, kT[i][j] = blur[j][i].
template <typename T, bool ADJOINT>
__device__ __forceinline__ void stage_frame_tables(const double* shifts, const T* blur, int kh, int kw,
                                                   int k0, int nk, T* tab, T (*tab_w)[4], int* tab_iy,
                                                   int* tab_ix) {
  const int tid = threadIdx.y * BX + threadIdx.x;
  const double sign = ADJOINT ? -1.0 : 1.0;
  const int rows = (ADJOINT ? kw : kh) + 1, cols = (ADJOINT ? kh : kw) + 1, E = rows * cols;
  for (int e = tid; e < nk * E; e += NT) {
    const int f = e / E, m = (e % E) / cols, n = (e % E) % cols;
    const double dx = sign * shifts[2 * (k0 + f)], dy = sign * shifts[2 * (k0 + f) + 1];
    const double fy = dy - floor(dy), fx = dx - floor(dx);
    const double wy[2] = {1.0 - fy, fy}, wx[2] = {1.0 - fx, fx};
    double acc = 0.0;
#pragma unroll
    for (int a = 0; a < 2; ++a) {
#pragma unroll
      for (int b = 0; b < 2; ++b) {
        const int i = m - 1 + a, j = n - 1 + b;
        if (i < 0 || i >= rows - 1 || j < 0 || j >= cols - 1) continue;
        const double tap = blur == nullptr ? 1.0 : (double)(ADJOINT ? blur[j * kw + i] : blur[i * kw + j]);
        acc += (wy[a] * wx[b]) * tap;
      }
    }
    tab[e] = (T)acc;
  }
  for (int f = tid; f < nk; f += NT) {
    T wt[4];
    warp_taps<T>(sign * shifts[2 * (k0 + f)], sign * shifts[2 * (k0 + f) + 1], tab_iy[f], tab_ix[f], wt);
#pragma unroll
    for (int q = 0; q < 4; ++q) tab_w[f][q] = wt[q];
  }
}

__device__ __forceinline__ int composite_chunk(int kh, int kw) {
  const int per_table = TAP_TABLE / ((kh + 1) * (kw + 1));
  return per_table < COMPOSITE_FRAMES ? per_table : COMPOSITE_FRAMES;
}

// Blocks of the residual and gradient kernels that one SM must hold at once:
// with the block size it caps the registers ptxas may use (65536 / (NT x
// blocks)). Both kernels wait on memory more than they compute, so the
// resident warps are their speed: 4 blocks (64 registers) for float with the
// 3 x 3 blur compiled in, 5 (51) for the gradient kernel at s = 2, which
// fits them; the run-time blur and double need more registers and get 3
// (85) or 2. Any tighter and ptxas spills (the residual kernel at 5 blocks
// did; 0 bytes of local memory is a requirement, and chip_smoke.py checks it
// for every instantiation).
template <typename T, int KB>
constexpr int composite_min_blocks() {
  return sizeof(T) == 8 ? (KB > 0 ? 3 : 2) : (KB > 0 ? 4 : 3);
}

template <typename T, int KB, int S>
constexpr int gradient_min_blocks() {
  return sizeof(T) == 4 && KB > 0 && S == 2 ? 5 : composite_min_blocks<T, KB>();
}

// ---------------------------------------------------------------------------
// Kernel 1: LR residual r_k = D B M_k x - y_k for every frame k, one block
// per BY x BX tile of LR values of one channel, one thread per LR value.
// Forward half of the Pallas data-term mode (`degrade.py:1111-1254`: warp
// stage, blur stage, masked residual, squared-residual cost), with its shard
// mode (`:663-715`) and spectral halo (`:994-1000`).
//
// What bounds it: its floor is bytes (x, y and r once). A thread that works
// alone is bound by instructions and L1 traffic:
// per frame, float64 taps, a walk over the blur taps with run-time bounds
// and four border tests per tap, up to 4 reads of x per blur tap (36 at
// 3 x 3), and x re-read for every frame. The design:
//  1. The block stages x in shared memory once, coalesced, several loads in
//     flight per thread: the rectangle of HR pixels its LR tile reads
//     through the blur and the bilinear taps of EVERY frame (the union over
//     the frames' integer shifts, found by the block from the device
//     shifts), zero outside the image and the array. Then it loops over the
//     frames itself; x is read from device memory once per block, not once
//     per frame. If the frames' shifts spread too far for the rectangle to
//     fit (more than FRAME_SPREAD pixels), it stages each frame's footprint
//     in turn (a branch the same for the whole block).
//  2. Per frame, the composite of warp and blur, a (kh+1) x (kw+1) table made
//     once per block from the device shifts in float64 and rounded once to
//     T, is read from shared memory: 16 reads of x per LR value at 3 x 3
//     instead of 36. An LR value whose blur taps all land inside the image
//     takes it; one in the band along the image's border takes the exact
//     two-stage form (warp output zero outside the image before the blur),
//     from the same staged x. The branch is hoisted out of the frame loop,
//     and y of the next frame is read while this one is computed.
//  3. s = 2 and 4 and a 3 x 3 blur are compile-time instantiations, S = 0 /
//     KB = 0 take them at run time (1.1-1.4x as long at the rows' 3 x 3,
//     PERF.md); no array is indexed at run time.
//  4. Each thread sums its LR value's squared residuals over the frames in
//     double; one partial per block, summed by kernel 3 in block order.
// What bounds it as built (PERF.md): the latency of the block's few
// dependent steps (shifts and tables, staging, barriers), not its bytes or
// instructions -- at 4 resident blocks per SM; 5 were 9 % faster at s = 2
// but made ptxas spill. Bank conflicts in the staged reads (lanes s values
// apart) cost nothing measurable: phase-plane staging that removed them was
// 10-17 % slower, and so was a second LR row per thread.
// ---------------------------------------------------------------------------
template <typename T, int S, int KB, bool SHARD>
__global__ void __launch_bounds__(NT, (composite_min_blocks<T, KB>())) sr_residual_kernel(
    const T* __restrict__ x, const T* __restrict__ y,
    const double* __restrict__ shifts, const T* __restrict__ blur, int kh_arg, int kw_arg,
    int K, int C, int H, int W, int s_arg, int h, int w,
    Tile where, const T* __restrict__ mask, int halo_band, int capacity,
    T* __restrict__ r, double* __restrict__ partials) {
  extern __shared__ __align__(16) unsigned char staged_bytes[];
  T* xs = reinterpret_cast<T*>(staged_bytes);  // `capacity` values
  __shared__ T tab_c[TAP_TABLE];
  __shared__ T tab_w[COMPOSITE_FRAMES][4];
  __shared__ int tab_iy[COMPOSITE_FRAMES], tab_ix[COMPOSITE_FRAMES];
  __shared__ int span[4];  // least and largest floor(dy), least and largest floor(dx)

  const int s = S > 0 ? S : s_arg;
  const int kh = KB > 0 ? KB : kh_arg, kw = KB > 0 ? KB : kw_arg;
  const int ar = kh / 2, ac = kw / 2;
  // A whole image is its own tile: the compiler then folds every test in
  // the image's coordinates into the test on the array's bounds beside it.
  const Tile tile = SHARD ? where : Tile{0, 0, H, W};
  const int tid = threadIdx.y * BX + threadIdx.x;
  const int c = blockIdx.z;
  const int qr0 = blockIdx.y * BY, qc0 = blockIdx.x * BX;
  const int qr = qr0 + threadIdx.y, qc = qc0 + threadIdx.x;
  const bool live = qr < h && qc < w;
  const bool halo = halo_band && c == C - 1;  // the same for the whole block
  // The LR pixels this launch answers for: the mask's, else those inside
  // the global image (the origin is a multiple of s, so the division is
  // exact); never the read-only halo band.
  bool owned = live && !halo;
  if (SHARD && owned && mask == nullptr) {
    const int gr = tile.u0 / s + qr, gc = tile.v0 / s + qc;
    owned = gr >= 0 && gr < tile.Hg / s && gc >= 0 && gc < tile.Wg / s;
  }
  // HR position of this LR value's first blur tap; all of its taps inside
  // the image: the composite is exact here.
  const int pr0 = s * qr - ar, pc0 = s * qc - ac;
  const bool interior = tile.u0 + pr0 >= 0 && tile.u0 + pr0 + kh <= tile.Hg && tile.v0 + pc0 >= 0 &&
                        tile.v0 + pc0 + kw <= tile.Wg;

  // 1. The first frames' tables and, in the same pass over the shifts, the
  //    spread of all frames' integer taps; then the rectangle of x: a frame
  //    with integer taps (iy, ix) reads rows s*qr0 - ar - iy - 1 + [0, fr)
  //    and columns likewise.
  const int chunk = composite_chunk(kh, kw), E = (kh + 1) * (kw + 1);
  if (tid < 4) span[tid] = (tid & 1) ? INT_MIN : INT_MAX;
  __syncthreads();
  for (int k = tid; k < K; k += NT) {
    const int iy = (int)floor(shifts[2 * k + 1]), ix = (int)floor(shifts[2 * k]);
    atomicMin(&span[0], iy);
    atomicMax(&span[1], iy);
    atomicMin(&span[2], ix);
    atomicMax(&span[3], ix);
  }
  stage_frame_tables<T, false>(shifts, blur, kh, kw, 0, K < chunk ? K : chunk, tab_c, tab_w, tab_iy, tab_ix);
  __syncthreads();
  const int fr = s * (BY - 1) + kh + 1, fc = s * (BX - 1) + kw + 1;
  int nr = fr + span[1] - span[0], nc = fc + span[3] - span[2];
  int row0 = s * qr0 - ar - span[1] - 1, col0 = s * qc0 - ac - span[3] - 1;
  const bool once = nr * nc <= capacity;  // the same for the whole block
  if (!once) nr = fr, nc = fc;
  const T* xc = x + (size_t)c * H * W;
  if (once && !halo) stage_rect<T>(xs, xc, H, W, tile, row0, col0, nr, nc);

  // z = (B M_k x)(s qr, s qc) from the staged x: the composite where this
  // value is interior, else the two-stage form (warp output zero outside the
  // image before the blur reads it).
  auto composite = [&](int kk) {
    const int rb = pr0 - tab_iy[kk] - 1 - row0, cb = pc0 - tab_ix[kk] - 1 - col0;  // staged first tap
    const T* ck = tab_c + kk * E;
    T z = (T)0;
#pragma unroll
    for (int m = 0; m <= kh; ++m) {
#pragma unroll
      for (int n = 0; n <= kw; ++n) z += ck[m * (kw + 1) + n] * xs[(rb + m) * nc + cb + n];
    }
    return z;
  };
  auto two_stage = [&](int kk) {
    const int rb = pr0 - tab_iy[kk] - 1 - row0, cb = pc0 - tab_ix[kk] - 1 - col0;
    const T w0 = tab_w[kk][0], w1 = tab_w[kk][1], w2 = tab_w[kk][2], w3 = tab_w[kk][3];
    T z = (T)0;
    for (int i = 0; i < kh; ++i) {
      const int gpr = tile.u0 + pr0 + i;
      if (gpr < 0 || gpr >= tile.Hg) continue;  // warp output is zero outside the image
      for (int j = 0; j < kw; ++j) {
        const int gpc = tile.v0 + pc0 + j;
        if (gpc < 0 || gpc >= tile.Wg) continue;
        // Tap (a, b) of the warp at (pr0 + i, pc0 + j) reads x at staged
        // (rb + 1 + i - a, cb + 1 + j - b).
        const T* xq = xs + (rb + 1 + i) * nc + cb + 1 + j;
        T val = (T)0;
        val += w0 * xq[0];
        val += w1 * xq[-1];
        val += w2 * xq[-nc];
        val += w3 * xq[-nc - 1];
        const T tap = blur ? blur[i * kw + j] : (T)1;
        z += tap * val;
      }
    }
    return z;
  };
  double sq = 0.0;
  const size_t frame_stride = (size_t)C * h * w, at = ((size_t)c * h + qr) * w + qc;
  auto put = [&](int k, T z, T yk) {  // r_k = mask (z - y_k), its square into the cost
    if (!live) return;
    T res = (T)0;
    if (owned) {
      res = z - yk;
      if (SHARD && mask != nullptr) res *= mask[(size_t)qr * w + qc];
    }
    r[k * frame_stride + at] = res;
    sq += (double)res * (double)res;
  };
  auto y_of = [&](int k) { return owned ? y[k * frame_stride + at] : (T)0; };

  for (int k0 = 0; k0 < K; k0 += chunk) {
    const int nk = K - k0 < chunk ? K - k0 : chunk;
    __syncthreads();  // x is staged; the previous chunk's tables are read no more
    if (k0 > 0) {
      stage_frame_tables<T, false>(shifts, blur, kh, kw, k0, nk, tab_c, tab_w, tab_iy, tab_ix);
      __syncthreads();
    }
    if (!once && !halo) {  // each frame's footprint in turn
      for (int kk = 0; kk < nk; ++kk) {
        __syncthreads();  // the previous frame's footprint is read no more
        row0 = s * qr0 - ar - tab_iy[kk] - 1;
        col0 = s * qc0 - ac - tab_ix[kk] - 1;
        stage_rect<T>(xs, xc, H, W, tile, row0, col0, nr, nc);
        __syncthreads();
        put(k0 + kk, owned ? (interior ? composite(kk) : two_stage(kk)) : (T)0, y_of(k0 + kk));
      }
    } else if (owned && interior) {  // y of the next frame is read while this one is computed
      T y_next = y_of(k0);
      for (int kk = 0; kk < nk; ++kk) {
        const T yk = y_next;
        if (kk + 1 < nk) y_next = y_of(k0 + kk + 1);
        put(k0 + kk, composite(kk), yk);
      }
    } else {
      for (int kk = 0; kk < nk; ++kk) put(k0 + kk, owned ? two_stage(kk) : (T)0, y_of(k0 + kk));
    }
  }
  const double total = block_sum(sq);
  if (tid == 0) partials[linear_block()] = total;
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

// G = 2 c r of the TV term at one site, r = |dx| + |dy| (+ |dz|).
template <typename T, bool TV3D>
__device__ __forceinline__ T tv_weight(T cq, T dx, T dy, T dz) {
  T rq = absval(dx) + absval(dy);
  if (TV3D) rq = rq + absval(dz);
  return ((T)2 * cq) * rq;
}

// ---------------------------------------------------------------------------
// Kernel 2: gradient, one block per grad_tile_rows x BX tile of HR pixels of
// one channel, a column of pixels BY rows apart a thread. Adjoint half of the Pallas data-term mode
// (`degrade.py:1111-1254`: transposed blur of r, reverse warp, 2 s^2 scale)
// plus, by MODE, the fused 2D TV (`:1256-1404`) or the fused 3D spectral TV
// (`:1297-1305`, `:1349-1402`, the TV mode's `tv_use_3d`), in shard mode as
// well; the BTV mode is kernel 2b.
//   grad = 2 s^2 sum_k M_k^T B^T D^T r_k  (+ TV gradient),
// and the tile's regulariser cost c r^2 into a per-block partial.
//
// What bounds it: its floor is bytes (x, r, the constants and grad once).
// A thread that works alone is bound by instructions: per frame, float64
// taps and, for each of its four bilinear samples, a walk over the blur taps
// with remainders and divisions by the run-time s; for the TV term the
// differences of three sites (four with 3D TV), 9-12 reads of x. The design:
//  1. Per frame, the composite of the transposed blur with the reverse warp,
//     a (kw+1) x (kh+1) table made once per block in float64 and rounded
//     once to T, sits in shared memory. A pixel of phase (u mod s, v mod s)
//     meets at most ceil((kw+1)/s) x ceil((kh+1)/s) LR samples of it -- one at
//     s = 4 and 3 x 3, four at s = 2 -- each read with its table weight; with
//     s and the blur compile-time the count is fixed, so all of a frame's
//     loads for the thread's pixels are issued before the first is used.
//     At s = 4 with a 3 x 3 blur, a thread whose pixels keep every bilinear
//     sample inside the image and every LR sample inside the array for all
//     frames takes a loop without tests; a pixel in the border band takes
//     the exact two-stage form.
//  2. s = 2 and 4 and a 3 x 3 blur are compile-time instantiations (S = 0 /
//     KB = 0 take them at run time): with the blur at run time the kernel
//     took 1.2-2.1x as long on every row (PERF.md). A thread owns
//     grad_tile_rows / BY pixels of one column, so a block's tables and
//     barriers serve more work.
//  3. TV: x over the tile and one row and column on each side, the
//     constants (and, 3D, x of band c + 1) at the G sites, and with 3D x and
//     the constants of band c - 1 are staged in one pass; G = 2 c r is made
//     once per site over the tile and its up-left margin into a shared G map
//     (over the staged constants); each pixel then reads its neighbours' G
//     and differences from shared memory.
//  4. Gather form: each output written by one thread, no atomics; the cost
//     partial per block in double.
// What bounds it as built (PERF.md): latency, about 37 us per frame at 64 x
// 256 x 256, s = 2, the same whether r is read through L1 or from windows
// staged in shared memory; not bytes (20 us for all of it) nor issue.
// ---------------------------------------------------------------------------
template <typename T, int MODE, int S, int KB, bool SHARD>
__global__ void __launch_bounds__(NT, (gradient_min_blocks<T, KB, S>())) sr_gradient_kernel(
    const T* __restrict__ x, const T* __restrict__ r,
    const double* __restrict__ shifts, const T* __restrict__ blur, int kh_arg, int kw_arg,
    int K, int C, int H, int W, int s_arg, int h, int w, Tile where,
    const T* __restrict__ constants, T* __restrict__ grad, double* __restrict__ partials) {
  constexpr bool TV = MODE == MODE_TV || MODE == MODE_TV3D;
  constexpr bool TV3D = MODE == MODE_TV3D;
  // LR samples per axis a pixel meets in the composite when s and the blur
  // are compile-time (square blur KB x KB): ceil((KB + 1) / S); else 0.
  constexpr int NM = (S > 0 && KB > 0) ? (KB + S) / S : 0;
  __shared__ T tab_a[TAP_TABLE];
  __shared__ T tab_w[COMPOSITE_FRAMES][4];
  __shared__ int tab_iy[COMPOSITE_FRAMES], tab_ix[COMPOSITE_FRAMES];
  // The TV term's inputs, staged in one pass: x over the tile and one row
  // and column on each side, the constants (and, 3D, x of band c + 1) at
  // the G sites, the tile and its up-left margin; with 3D, x of band c - 1
  // over the tile and one row and column down-right, and its constants.
  // Each site's G replaces its constant once read (the same thread does both).
  constexpr int TH = grad_tile_rows<T>(), RY = TH / BY;
  constexpr int GH = TV ? TH + 1 : 1, GW = BX + 1, PH = TV3D ? TH + 1 : 1;
  __shared__ T xs[TV ? TH + 2 : 1][BX + 2];  // x(R0 - 1 + i, C0 - 1 + j)
  __shared__ T cs[GH][GW];                   // c(R0 - 1 + i, C0 - 1 + j), then G there
  __shared__ T xn[PH][GW];                   // x of band c + 1 at (R0 - 1 + i, C0 - 1 + j)
  __shared__ T xp[PH][GW];                   // x of band c - 1 at (R0 + i, C0 + j)
  __shared__ T cp[PH][GW];                   // c of band c - 1 at (R0 + i, C0 + j)
  T(*gs)[GW] = cs;

  const int s = S > 0 ? S : s_arg;
  const int kh = KB > 0 ? KB : kh_arg, kw = KB > 0 ? KB : kw_arg;
  const int ar = kw / 2, ac = kh / 2;  // kernel^T has kw rows and kh columns
  const Tile tile = SHARD ? where : Tile{0, 0, H, W};  // see sr_residual_kernel
  const int tx = threadIdx.x, ty = threadIdx.y, tid = ty * BX + tx;
  const int c = blockIdx.z;
  const int R0 = blockIdx.y * TH, C0 = blockIdx.x * BX;
  const int v = C0 + tx;  // this thread's pixels: rows R0 + ty + BY a of column v
  const size_t plane = (size_t)H * W, base = (size_t)c * plane;
  if constexpr (TV) {  // zero beyond the array; several loads in flight per thread
    const T* xc = x + base;
    const T* cc = constants + base;
#pragma unroll 2
    for (int e = tid; e < (TH + 2) * (BX + 2); e += NT) {
      const int i = e / (BX + 2), j = e % (BX + 2);
      const int rr = R0 - 1 + i, cl = C0 - 1 + j;
      const bool in = rr >= 0 && rr < H && cl >= 0 && cl < W;
      const size_t at = (size_t)rr * W + cl;
      xs[i][j] = in ? xc[at] : (T)0;
      if (i < GH && j < GW) {
        cs[i][j] = in ? cc[at] : (T)0;
        if constexpr (TV3D) xn[i][j] = in && c + 1 < C ? xc[plane + at] : (T)0;
      }
      if constexpr (TV3D) {
        if (i >= 1 && j >= 1) {
          xp[i - 1][j - 1] = in && c > 0 ? xc[at - plane] : (T)0;
          cp[i - 1][j - 1] = in && c > 0 ? cc[at - plane] : (T)0;
        }
      }
    }
  }

  const int chunk = composite_chunk(kh, kw), E = (kh + 1) * (kw + 1);
  // 1. 2 s^2 sum_k M_k^T B^T D^T r_k. The composite at pixel (u, v) for
  //    frame k (tables at kk): the LR rows it reaches are (oy + m) / s, m in
  //    [0, kw], where a multiple of s -- exactly NM of them when s and the
  //    blur are compile-time, so every load is issued before the first is
  //    used; columns alike.
  auto composite = [&](int k, int kk, int u) {
    const T* rk = r + ((size_t)k * C + c) * h * w;
    const T* ak = tab_a + kk * E;
    const int oy = u - tab_iy[kk] - 1 - ar, ox = v - tab_ix[kk] - 1 - ac;
    const int m0 = phase<S>(-oy, s), n0 = phase<S>(-ox, s);
    T gk = (T)0;
    if constexpr (NM > 0) {
#pragma unroll
      for (int i = 0; i < NM; ++i) {
        const int m = m0 + S * i;
        if ((KB + 1) % S != 0 && m > KB) break;
        const T* rrow = rk + (size_t)((unsigned)(oy + m) / (unsigned)S) * w;
#pragma unroll
        for (int j = 0; j < NM; ++j) {
          const int n = n0 + S * j;
          if ((KB + 1) % S != 0 && n > KB) break;
          gk += ak[m * (KB + 1) + n] * rrow[(unsigned)(ox + n) / (unsigned)S];
        }
      }
    } else {
      for (int m = m0; m <= kw; m += s) {
        const T* rrow = rk + (size_t)((unsigned)(oy + m) / (unsigned)s) * w;
        for (int n = n0; n <= kh; n += s) gk += ak[m * (kh + 1) + n] * rrow[(unsigned)(ox + n) / (unsigned)s];
      }
    }
    return gk;
  };
  T acc[RY];
#pragma unroll
  for (int a = 0; a < RY; ++a) acc[a] = (T)0;
  for (int k0 = 0; k0 < K; k0 += chunk) {
    const int nk = K - k0 < chunk ? K - k0 : chunk;
    __syncthreads();  // the previous chunk's tables are read no more
    stage_frame_tables<T, true>(shifts, blur, kh, kw, k0, nk, tab_a, tab_w, tab_iy, tab_ix);
    __syncthreads();
    if (v >= W) continue;
    // The thread's pixels take the composite without a test when every
    // frame of the chunk keeps all their bilinear samples inside the image
    // and every LR sample inside the array: in rows u - iy - 1 .. u - iy and
    // LR rows (oy + m) / s, oy = u - iy - 1 - ar, m in [0, kw] (columns alike).
    // Only where a pixel meets one LR sample per frame (NM = 1: s = 4 at
    // 3 x 3), where it was measured up to 9 % faster than the per-pixel test
    // below; at s = 2 it was 2-4 % slower (PERF.md).
    if constexpr (NM == 1) {
      int iy_lo = INT_MAX, iy_hi = INT_MIN, ix_lo = INT_MAX, ix_hi = INT_MIN;
      for (int kk = 0; kk < nk; ++kk) {
        iy_lo = min(iy_lo, tab_iy[kk]);
        iy_hi = max(iy_hi, tab_iy[kk]);
        ix_lo = min(ix_lo, tab_ix[kk]);
        ix_hi = max(ix_hi, tab_ix[kk]);
      }
      const int u_first = R0 + ty, u_last = R0 + ty + BY * (RY - 1);
      bool inside = u_last < H && u_first - iy_hi - 1 - ar >= 0 && u_last - iy_lo - 1 - ar + kw < H &&
                    v - ix_hi - 1 - ac >= 0 && v - ix_lo - 1 - ac + kh < W;
      if (SHARD) {
        inside = inside && tile.u0 + u_first - iy_hi - 1 >= 0 && tile.u0 + u_last - iy_lo < tile.Hg &&
                 tile.v0 + v - ix_hi - 1 >= 0 && tile.v0 + v - ix_lo < tile.Wg;
      }
      if (inside) {  // no test inside: the pixels' loads of a frame in flight together
        for (int kk = 0; kk < nk; ++kk) {
#pragma unroll
          for (int a = 0; a < RY; ++a) acc[a] += composite(k0 + kk, kk, R0 + ty + BY * a);
        }
        continue;
      }
    }
    for (int kk = 0; kk < nk; ++kk) {
      const int iy = tab_iy[kk], ix = tab_ix[kk];
      const T* rk = r + ((size_t)(k0 + kk) * C + c) * h * w;
#pragma unroll
      for (int a = 0; a < RY; ++a) {
        const int u = R0 + ty + BY * a;
        if (u >= H) continue;
        const int oy = u - iy - 1 - ar, ox = v - ix - 1 - ac;
        bool interior = oy >= 0 && oy + kw < H && ox >= 0 && ox + kh < W;
        if (SHARD) {
          interior = interior && tile.u0 + u - iy - 1 >= 0 && tile.u0 + u - iy < tile.Hg &&
                     tile.v0 + v - ix - 1 >= 0 && tile.v0 + v - ix < tile.Wg;
        }
        T gk = (T)0;
        if (interior) {
          gk = composite(k0 + kk, kk, u);
        } else {
#pragma unroll
          for (int a2 = 0; a2 < 2; ++a2) {
#pragma unroll
            for (int b = 0; b < 2; ++b) {
              const T wgt = tab_w[kk][2 * a2 + b];
              if (wgt != (T)0)
                gk += wgt * adjoint_sample<T>(rk, blur, kh, kw, s, h, w, tile, u - iy - a2, v - ix - b);
            }
          }
        }
        acc[a] += gk;
      }
    }
  }
  const T scale2 = (T)(2.0 * (double)s * (double)s);

  if constexpr (!TV) {
#pragma unroll
    for (int a = 0; a < RY; ++a) {
      const int u = R0 + ty + BY * a;
      if (u < H && v < W) grad[base + (size_t)u * W + v] = scale2 * acc[a];
    }
  } else {
    // 2. The TV term from the staged inputs and the G map: G at this
    //    thread's pixels and at the margin (the row above the tile, BX + 1
    //    sites, and the column to its left, TH sites; zero beyond the
    //    array), then each pixel's terms. The cost c r^2 of the tile's own pixels.
    double reg_cost = 0.0;
    // G at staged site (gy, gx), image position (qr, qc) = (R0 - 1 + gy, C0 - 1 + gx).
    auto g_site = [&](int gy, int gx, int qr, int qc, double* cost) {
      if (qr < 0 || qr >= H || qc < 0 || qc >= W) return (T)0;
      const T xq = xs[gy][gx], cq = cs[gy][gx];
      const T dx = (tile.v0 + qc + 1 < tile.Wg) ? xs[gy][gx + 1] - xq : (T)0;
      const T dy = (tile.u0 + qr + 1 < tile.Hg) ? xs[gy + 1][gx] - xq : (T)0;
      T dz = (T)0;
      if constexpr (TV3D) dz = (c + 1 < C) ? xn[gy][gx] - xq : (T)0;
      T rq = absval(dx) + absval(dy);
      if (TV3D) rq = rq + absval(dz);
      if (cost != nullptr) *cost += (double)((cq * rq) * rq);
      return ((T)2 * cq) * rq;
    };
#pragma unroll
    for (int a = 0; a < RY; ++a) {
      const int ly = ty + BY * a + 1, lx = tx + 1;
      gs[ly][lx] = g_site(ly, lx, R0 + ly - 1, v, &reg_cost);
    }
    if (tid < BX + 1 + TH) {
      const int gy = tid <= BX ? 0 : tid - BX, gx = tid <= BX ? tid : 0;
      gs[gy][gx] = g_site(gy, gx, R0 - 1 + gy, C0 - 1 + gx, nullptr);
    }
    __syncthreads();
#pragma unroll
    for (int a = 0; a < RY; ++a) {
      const int u = R0 + ty + BY * a, ly = ty + BY * a + 1, lx = tx + 1;
      if (u >= H || v >= W) continue;
      // In the plain version's order: the 2D terms, then (3D) -G s_z here
      // and +G s_z of band c - 1 (nothing flows into band 0).
      const T x0 = xs[ly][lx], g0 = gs[ly][lx];
      const T dx0 = (tile.v0 + v + 1 < tile.Wg) ? xs[ly][lx + 1] - x0 : (T)0;
      const T dy0 = (tile.u0 + u + 1 < tile.Hg) ? xs[ly + 1][lx] - x0 : (T)0;
      T tv = -g0 * (sgn(dx0) + sgn(dy0));
      if (v > 0) {  // gx of the left neighbour
        const T dxl = (tile.v0 + v < tile.Wg) ? x0 - xs[ly][lx - 1] : (T)0;
        tv += gs[ly][lx - 1] * sgn(dxl);
      }
      if (u > 0) {  // gy of the upper neighbour
        const T dyu = (tile.u0 + u < tile.Hg) ? x0 - xs[ly - 1][lx] : (T)0;
        tv += gs[ly - 1][lx] * sgn(dyu);
      }
      if constexpr (TV3D) {
        const T dz0 = (c + 1 < C) ? xn[ly][lx] - x0 : (T)0;
        tv -= g0 * sgn(dz0);
        if (c > 0) {  // band c - 1 at this pixel: xp, cp at (ly - 1, lx - 1)
          const T xpp = xp[ly - 1][lx - 1];
          const T dxp = (tile.v0 + v + 1 < tile.Wg) ? xp[ly - 1][lx] - xpp : (T)0;
          const T dyp = (tile.u0 + u + 1 < tile.Hg) ? xp[ly][lx - 1] - xpp : (T)0;
          const T dzp = x0 - xpp;
          tv += tv_weight<T, true>(cp[ly - 1][lx - 1], dxp, dyp, dzp) * sgn(dzp);
        }
      }
      grad[base + (size_t)u * W + v] = scale2 * acc[a] + tv;
    }
    const double total = block_sum(reg_cost);
    if (tid == 0) partials[linear_block()] = total;
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

// The residual and gradient kernels for a scale, blur and kind of array:
// s = 2 and 4 and a 3 x 3 blur have instantiations of their own; any other
// s, any other blur (and none) shares the run-time one.
template <typename T>
using ResidualKernel = void (*)(const T*, const T*, const double*, const T*, int, int, int, int, int,
                                int, int, int, int, Tile, const T*, int, int, T*, double*);
template <typename T>
using GradientKernel = void (*)(const T*, const T*, const double*, const T*, int, int, int, int, int,
                                int, int, int, int, Tile, const T*, T*, double*);

inline bool blur_3x3(int kh, int kw) { return kh == 3 && kw == 3; }

template <typename T, int S, bool SHARD>
ResidualKernel<T> residual_kernel_for_blur(int kh, int kw) {
  return blur_3x3(kh, kw) ? sr_residual_kernel<T, S, 3, SHARD> : sr_residual_kernel<T, S, 0, SHARD>;
}

template <typename T>
ResidualKernel<T> residual_kernel(int s, int kh, int kw, bool shard) {
  if (shard) {
    if (s == 2) return residual_kernel_for_blur<T, 2, true>(kh, kw);
    if (s == 4) return residual_kernel_for_blur<T, 4, true>(kh, kw);
    return residual_kernel_for_blur<T, 0, true>(kh, kw);
  }
  if (s == 2) return residual_kernel_for_blur<T, 2, false>(kh, kw);
  if (s == 4) return residual_kernel_for_blur<T, 4, false>(kh, kw);
  return residual_kernel_for_blur<T, 0, false>(kh, kw);
}

template <typename T, int MODE, int S, bool SHARD>
GradientKernel<T> gradient_kernel_for_blur(int kh, int kw) {
  return blur_3x3(kh, kw) ? sr_gradient_kernel<T, MODE, S, 3, SHARD>
                          : sr_gradient_kernel<T, MODE, S, 0, SHARD>;
}

template <typename T, int MODE, bool SHARD>
GradientKernel<T> gradient_kernel_for_scale(int s, int kh, int kw) {
  if (s == 2) return gradient_kernel_for_blur<T, MODE, 2, SHARD>(kh, kw);
  if (s == 4) return gradient_kernel_for_blur<T, MODE, 4, SHARD>(kh, kw);
  return gradient_kernel_for_blur<T, MODE, 0, SHARD>(kh, kw);
}

// nullptr for the BTV mode (kernel 2b) or a mode out of range.
template <typename T>
GradientKernel<T> gradient_kernel(int mode, int s, int kh, int kw, bool shard) {
  switch (mode) {
    case MODE_DATA:
      return shard ? gradient_kernel_for_scale<T, MODE_DATA, true>(s, kh, kw)
                   : gradient_kernel_for_scale<T, MODE_DATA, false>(s, kh, kw);
    case MODE_TV:
      return shard ? gradient_kernel_for_scale<T, MODE_TV, true>(s, kh, kw)
                   : gradient_kernel_for_scale<T, MODE_TV, false>(s, kh, kw);
    case MODE_TV3D:
      return shard ? gradient_kernel_for_scale<T, MODE_TV3D, true>(s, kh, kw)
                   : gradient_kernel_for_scale<T, MODE_TV3D, false>(s, kh, kw);
    default:
      return nullptr;
  }
}

// Shared memory a block may have on this card beyond its static arrays.
constexpr size_t MAX_BLOCK_SHARED = 227 * 1024;
constexpr size_t RESIDUAL_STATIC_SHARED = 12 * 1024;  // tables, taps, spread (double: 10.8 KB)

// Values of x the residual kernel stages: one frame's footprint, grown by
// FRAME_SPREAD rows and columns where that fits; 0 if not even the
// footprint fits.
template <typename T>
int residual_capacity(int s, int kh, int kw) {
  const size_t fr = (size_t)s * (BY - 1) + kh + 1, fc = (size_t)s * (BX - 1) + kw + 1;
  const size_t room = (MAX_BLOCK_SHARED - RESIDUAL_STATIC_SHARED) / sizeof(T);
  const size_t grown = (fr + FRAME_SPREAD) * (fc + FRAME_SPREAD);
  if (grown <= room) return (int)grown;
  return fr * fc <= room ? (int)(fr * fc) : 0;
}

template <typename T>
int launch_residual(const void* x, const void* y, const double* shifts, const void* blur,
                    int kh, int kw, int K, int C, int H, int W, int s, Tile tile,
                    const void* mask, int halo_band, void* r, double* partials,
                    cudaStream_t stream) {
  const int h = H / s, w = W / s;
  const int capacity = residual_capacity<T>(s, kh, kw);
  if (capacity == 0) return -10;
  const size_t bytes = (size_t)capacity * sizeof(T);
  const bool shard = !is_whole_image(tile, H, W) || mask != nullptr;
  const ResidualKernel<T> kernel = residual_kernel<T>(s, kh, kw, shard);
  if (bytes > 32 * 1024) {  // past the default limit with the static arrays
    const cudaError_t err =
        cudaFuncSetAttribute((const void*)kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (err != cudaSuccess) return (int)err;
  }
  dim3 block(BX, BY), grid(ceil_div(w, BX), ceil_div(h, BY), C);
  kernel<<<grid, block, bytes, stream>>>((const T*)x, (const T*)y, shifts, (const T*)blur, kh, kw, K, C,
                                         H, W, s, h, w, tile, (const T*)mask, halo_band, capacity,
                                         (T*)r, partials);
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
  dim3 grid(ceil_div(W, BX), ceil_div(H, grad_tile_rows<T>()), C);
  const GradientKernel<T> kernel = gradient_kernel<T>(mode, s, kh, kw, !whole);
  kernel<<<grid, block, 0, stream>>>((const T*)x, (const T*)r, shifts, (const T*)blur, kh, kw, K, C, H,
                                     W, s, h, w, tile, (const T*)constants, (T*)grad, partials);
  return (int)cudaGetLastError();
}

template <typename T>
const void* kernel_function(int kernel, int mode_or_range, int s, int blur, bool shard) {
  switch (kernel) {
    case 0: return (const void*)residual_kernel<T>(s, blur, blur, shard);
    case 1: return (const void*)gradient_kernel<T>(mode_or_range, s, blur, blur, shard);
    case 2: return (const void*)btv_kernel<T>(mode_or_range, s, shard);
    default: return nullptr;
  }
}

}  // namespace

// Plain C interface. Every pointer is a device pointer, except `tile` (four
// ints on the host, read before the launch); `stream` is a cudaStream_t. Each launcher returns cudaGetLastError() (0 = success) or a
// negative code for an argument it refuses.
extern "C" {

// Number of per-block cost partials each kernel writes for a problem size.
int sr_residual_blocks(int C, int H, int W, int s) {
  return ceil_div(W / s, BX) * ceil_div(H / s, BY) * C;
}

// The data mode writes none; the BTV kernel's blocks are tiles of BTV_TH x
// BTV_TW, the TV modes' of grad_tile_rows (which depends on the type) x BX.
int sr_gradient_blocks(int mode, int C, int H, int W, int is_double) {
  if (mode == MODE_DATA) return 0;
  if (mode == MODE_BTV) return ceil_div(W, BTV_TW) * ceil_div(H, BTV_TH) * C;
  const int rows = is_double ? grad_tile_rows<double>() : grad_tile_rows<float>();
  return ceil_div(W, BX) * ceil_div(H, rows) * C;
}

int sr_max_btv_range() { return MAX_BTV_RANGE; }

// The largest (kh + 1) * (kw + 1) the residual and gradient kernels take.
int sr_max_composite_taps() { return TAP_TABLE; }

// Values of x the residual kernel stages per block for a scale and blur; 0
// if not even one frame's footprint fits in a block's shared memory (the
// launch is then refused with -10).
int sr_residual_staging(int s, int kh, int kw, int is_double) {
  return is_double ? residual_capacity<double>(s, kh, kw) : residual_capacity<float>(s, kh, kw);
}

// What the compiler gave one instantiation (cudaFuncGetAttributes): `kernel`
// 0 = sr_residual_kernel, 1 = sr_gradient_kernel (`mode_or_range` its mode:
// 0 data, 1 TV, 3 3D TV), 2 = sr_btv_gradient_kernel (`mode_or_range` its
// range P); scale s (2 and 4 have instantiations of their own, any other s
// shares one), `blur` 3 for the 3 x 3 instantiation (any other: the
// run-time one; the BTV kernel has none), a tile (shard != 0) or whole
// image. out = {registers per thread, local memory bytes per thread, static
// shared memory bytes per block, max threads per block, blocks per SM}. Returns the
// cudaError_t of cudaFuncGetAttributes, or -5 for no such instantiation.
int sr_kernel_attributes(int kernel, int mode_or_range, int s, int blur, int shard, int is_double,
                         int* out) {
  const void* fn = is_double ? kernel_function<double>(kernel, mode_or_range, s, blur, shard != 0)
                             : kernel_function<float>(kernel, mode_or_range, s, blur, shard != 0);
  if (fn == nullptr) return -5;
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, fn);
  if (err != cudaSuccess) return (int)err;
  out[0] = attr.numRegs;
  out[1] = (int)attr.localSizeBytes;
  out[2] = (int)attr.sharedSizeBytes;
  out[3] = attr.maxThreadsPerBlock;
  // Blocks an SM holds at once, as the kernels are launched (the residual
  // kernel with its staged x for this scale and blur).
  size_t dynamic = 0;
  if (kernel == 0) {
    dynamic = is_double ? residual_capacity<double>(s, blur, blur) * sizeof(double)
                        : residual_capacity<float>(s, blur, blur) * sizeof(float);
    if (dynamic > 32 * 1024) cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)dynamic);
  }
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&out[4], fn, NT, dynamic);
  return (int)err;
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
// halo (needs C >= 2). Refused (-10): a blur larger than the tap table, or a
// scale and blur whose staged rectangle of x exceeds a block's shared memory.
int sr_data_residual(const void* x, const void* y, const double* shifts, const void* blur,
                     int kh, int kw, int K, int C, int H, int W, int s, const int* tile,
                     const void* mask, int halo_band, void* r, double* partials, int is_double,
                     void* stream) {
  if (s < 1 || H % s != 0 || W % s != 0 || kh < 1 || kw < 1 || K < 1 || C < 1) return -1;
  if (C > 65535) return -2;
  if ((kh + 1) * (kw + 1) > TAP_TABLE) return -10;
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
  if (mode != MODE_BTV && (kh + 1) * (kw + 1) > TAP_TABLE) return -10;
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
