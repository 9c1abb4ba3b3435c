// Hand-written Hopper (sm_90a) kernels for the fused MAP objective.
//
// Together the three kernels below replace the static single-device modes of
// the Pallas TPU kernel `pallas_data_term_cost_and_grad`
// (super_resolution_tpu/ops/pallas/degrade.py):
//
//   data term                 cost  s^2 sum_k ||D B M_k x - y_k||^2
//                             grad  2 s^2 sum_k M_k^T B^T D^T r_k
//   + fused 2D TV             cost  sum c r^2, r = |dx| + |dy|
//   + fused bilateral TV      cost  sum c r^2, r = sum a^(i+j) |x - shift_ij x|
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
// Bound on this card: the least an evaluation can take is set by memory
// traffic. It must read x, y and the constants and write the gradient once;
// the LR residual r (K*C*H*W/s^2 values) is the one intermediate that
// round-trips through device memory, and all neighbour re-reads (blur taps,
// TV / BTV windows) hit L1/L2. That byte bound is the target, and the design
// keeps the number of full-image passes at the minimum of two and recomputes
// rather than stores (the BTV residual of each overlap source). As written
// the kernels do not reach it: they are instruction-bound, because each
// thread divides and takes remainders by the runtime scale s in its tap loops
// and rebuilds every frame's bilinear taps in float64. Making s a template
// parameter and computing the taps once per block is the next step.

#include <cuda_runtime.h>
#include <stddef.h>

namespace {

constexpr int BX = 32;        // block width  (fastest-varying image axis)
constexpr int BY = 8;         // block height
constexpr int NT = BX * BY;   // threads per block
constexpr int MAX_BTV_RANGE = 8;
constexpr int REDUCE_THREADS = 1024;

enum Mode { MODE_DATA = 0, MODE_TV = 1, MODE_BTV = 2 };

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
template <typename T>
__global__ void __launch_bounds__(NT) sr_residual_kernel(
    const T* __restrict__ x, const T* __restrict__ y,
    const double* __restrict__ shifts, const T* __restrict__ blur, int kh, int kw,
    int C, int H, int W, int s, int h, int w,
    T* __restrict__ r, double* __restrict__ partials) {
  const int qc = blockIdx.x * BX + threadIdx.x;
  const int qr = blockIdx.y * BY + threadIdx.y;
  const int kc = blockIdx.z;
  const int k = kc / C, c = kc % C;
  double sq = 0.0;
  if (qr < h && qc < w) {
    int iy, ix;
    T wt[4];
    warp_taps<T>(shifts[2 * k], shifts[2 * k + 1], iy, ix, wt);
    const T* xc = x + (size_t)c * H * W;
    const int ar = kh / 2, ac = kw / 2;
    T z = (T)0;
    for (int i = 0; i < kh; ++i) {
      const int pr = s * qr + i - ar;
      if (pr < 0 || pr >= H) continue;  // warp output is zero outside the image
      for (int j = 0; j < kw; ++j) {
        const int pc = s * qc + j - ac;
        if (pc < 0 || pc >= W) continue;
        T val = (T)0;
#pragma unroll
        for (int a = 0; a < 2; ++a) {
          const int rr = pr - iy - a;
          if (rr < 0 || rr >= H) continue;
#pragma unroll
          for (int b = 0; b < 2; ++b) {
            const T wgt = wt[2 * a + b];
            const int cc = pc - ix - b;
            if (wgt == (T)0 || cc < 0 || cc >= W) continue;
            val += wgt * xc[(size_t)rr * W + cc];
          }
        }
        const T tap = blur ? blur[i * kw + j] : (T)1;
        z += tap * val;
      }
    }
    const size_t idx = ((size_t)kc * h + qr) * w + qc;
    const T res = z - y[idx];
    r[idx] = res;
    sq = (double)res * (double)res;
  }
  const double total = block_sum(sq);
  if (threadIdx.x == 0 && threadIdx.y == 0) partials[linear_block()] = total;
}

// ---------------------------------------------------------------------------
// Regulariser pieces, gather form.
// ---------------------------------------------------------------------------

// TV residual pieces at pixel (rr, cc): forward differences, zero past the border.
template <typename T>
__device__ __forceinline__ void tv_diffs(const T* xc, int H, int W, int rr, int cc, T& dx, T& dy) {
  const T x0 = xc[(size_t)rr * W + cc];
  dx = (cc + 1 < W) ? xc[(size_t)rr * W + cc + 1] - x0 : (T)0;
  dy = (rr + 1 < H) ? xc[(size_t)(rr + 1) * W + cc] - x0 : (T)0;
}

// BTV residual at pixel (qr, qc): inclusive window [0, P]^2.
template <typename T>
__device__ __forceinline__ T btv_residual(const T* xc, int H, int W, int qr, int qc, int P,
                                          const T* pw) {
  const T x0 = xc[(size_t)qr * W + qc];
  T rs = (T)0;
  for (int i = 0; i <= P && qr + i < H; ++i) {
    for (int j = 0; j <= P && qc + j < W; ++j) {
      if (i == 0 && j == 0) continue;
      rs += pw[i + j] * absval(x0 - xc[(size_t)(qr + i) * W + qc + j]);
    }
  }
  return rs;
}

// ---------------------------------------------------------------------------
// Kernel 2: gradient, one thread per HR pixel (c, u, v). Adjoint half of the
// Pallas data-term mode (transposed blur of r, reverse warp, 2 s^2 scale)
// plus, by MODE, the fused 2D TV or the fused BTV mode. Reads r (a 1/s^2
// image per frame, L2-resident), x and the constants, writes grad once:
// the bytes of x, constants and grad are its floor. It is where an
// evaluation's time goes (see the note on the bound at the top).
//   grad = 2 s^2 sum_k M_k^T B^T D^T r_k  (+ TV or BTV gradient),
// and the thread's own regulariser cost c r^2 into a per-block partial.
// ---------------------------------------------------------------------------
template <typename T, int MODE>
__global__ void __launch_bounds__(NT) sr_gradient_kernel(
    const T* __restrict__ x, const T* __restrict__ r,
    const double* __restrict__ shifts, const T* __restrict__ blur, int kh, int kw,
    int K, int C, int H, int W, int s, int h, int w,
    const T* __restrict__ constants, int P, double decay,
    T* __restrict__ grad, double* __restrict__ partials) {
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
        const int pr = u - iy - a;
        if (pr < 0 || pr >= H) continue;  // B^T D^T r is zero outside the image
#pragma unroll
        for (int b = 0; b < 2; ++b) {
          const T wgt = wt[2 * a + b];
          const int pc = v - ix - b;
          if (wgt == (T)0 || pc < 0 || pc >= W) continue;
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
      tv_diffs<T>(xc, H, W, u, v, dx0, dy0);
      const T c0 = cc[(size_t)u * W + v];
      const T r0 = absval(dx0) + absval(dy0);
      const T g0 = ((T)2 * c0) * r0;
      T tv = -g0 * (sgn(dx0) + sgn(dy0));
      if (v > 0) {  // gx of the left neighbour
        T dxl, dyl;
        tv_diffs<T>(xc, H, W, u, v - 1, dxl, dyl);
        const T gl = ((T)2 * cc[(size_t)u * W + v - 1]) * (absval(dxl) + absval(dyl));
        tv += gl * sgn(dxl);
      }
      if (u > 0) {  // gy of the upper neighbour
        T dxu, dyu;
        tv_diffs<T>(xc, H, W, u - 1, v, dxu, dyu);
        const T gu = ((T)2 * cc[(size_t)(u - 1) * W + v]) * (absval(dxu) + absval(dyu));
        tv += gu * sgn(dyu);
      }
      out += tv;
      reg_cost = (double)((c0 * r0) * r0);
    } else if constexpr (MODE == MODE_BTV) {
      const T* cc = constants + base;
      T pw[2 * MAX_BTV_RANGE + 1];
      {
        double p = 1.0;
        for (int n = 0; n <= 2 * P; ++n) {
          pw[n] = (T)p;
          p *= decay;
        }
      }
      const T x0 = xc[(size_t)u * W + v];
      const T c0 = cc[(size_t)u * W + v];
      const T r0 = btv_residual<T>(xc, H, W, u, v, P, pw);
      const T g0 = ((T)2 * c0) * r0;
      T btv = (T)0;
      // Gradient window is exclusive: [0, P)^2. The (0, 0) offset is zero.
      for (int i = 0; i < P; ++i) {
        for (int j = 0; j < P; ++j) {
          if (i == 0 && j == 0) continue;
          if (u + i < H && v + j < W) {
            btv += (pw[i + j] * g0) * sgn(x0 - xc[(size_t)(u + i) * W + v + j]);
          }
          // Overlap term sourced at q = p - (i, j); the source (0, 0) is skipped.
          const int qr = u - i, qc = v - j;
          if (qr >= 0 && qc >= 0 && !(qr == 0 && qc == 0)) {
            const T xq = xc[(size_t)qr * W + qc];
            const T rq = btv_residual<T>(xc, H, W, qr, qc, P, pw);
            const T gq = ((T)2 * cc[(size_t)qr * W + qc]) * rq;
            btv -= (pw[i + j] * gq) * sgn(xq - x0);
          }
        }
      }
      out += btv;
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

template <typename T>
int launch_residual(const void* x, const void* y, const double* shifts, const void* blur,
                    int kh, int kw, int K, int C, int H, int W, int s, void* r,
                    double* partials, cudaStream_t stream) {
  const int h = H / s, w = W / s;
  dim3 block(BX, BY), grid(ceil_div(w, BX), ceil_div(h, BY), K * C);
  sr_residual_kernel<T><<<grid, block, 0, stream>>>(
      (const T*)x, (const T*)y, shifts, (const T*)blur, kh, kw, C, H, W, s, h, w, (T*)r,
      partials);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_gradient(const void* x, const void* r, const double* shifts, const void* blur,
                    int kh, int kw, int K, int C, int H, int W, int s, int mode,
                    const void* constants, int P, double decay, void* grad,
                    double* partials, cudaStream_t stream) {
  const int h = H / s, w = W / s;
  dim3 block(BX, BY), grid(ceil_div(W, BX), ceil_div(H, BY), C);
#define SR_LAUNCH(M)                                                                     \
  sr_gradient_kernel<T, M><<<grid, block, 0, stream>>>(                                     \
      (const T*)x, (const T*)r, shifts, (const T*)blur, kh, kw, K, C, H, W, s, h, w,     \
      (const T*)constants, P, decay, (T*)grad, partials)
  if (mode == MODE_DATA) {
    SR_LAUNCH(MODE_DATA);
  } else if (mode == MODE_TV) {
    SR_LAUNCH(MODE_TV);
  } else {
    SR_LAUNCH(MODE_BTV);
  }
#undef SR_LAUNCH
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C interface. Every pointer is a device pointer; `stream` is a
// cudaStream_t. Each launcher returns cudaGetLastError() (0 = success) or a
// negative code for an argument it refuses.
extern "C" {

// Number of per-block cost partials each kernel writes for a problem size.
int sr_residual_blocks(int K, int C, int H, int W, int s) {
  return ceil_div(W / s, BX) * ceil_div(H / s, BY) * K * C;
}

int sr_gradient_blocks(int C, int H, int W) {
  return ceil_div(W, BX) * ceil_div(H, BY) * C;
}

int sr_max_btv_range() { return MAX_BTV_RANGE; }

int sr_data_residual(const void* x, const void* y, const double* shifts, const void* blur,
                     int kh, int kw, int K, int C, int H, int W, int s, void* r,
                     double* partials, int is_double, void* stream) {
  if (s < 1 || H % s != 0 || W % s != 0 || kh < 1 || kw < 1 || K < 1 || C < 1) return -1;
  if ((long long)K * C > 65535 || C > 65535) return -2;
  cudaStream_t st = (cudaStream_t)stream;
  return is_double
             ? launch_residual<double>(x, y, shifts, blur, kh, kw, K, C, H, W, s, r, partials, st)
             : launch_residual<float>(x, y, shifts, blur, kh, kw, K, C, H, W, s, r, partials, st);
}

int sr_objective_gradient(const void* x, const void* r, const double* shifts, const void* blur,
                          int kh, int kw, int K, int C, int H, int W, int s, int mode,
                          const void* constants, int btv_range, double btv_decay, void* grad,
                          double* reg_partials, int is_double, void* stream) {
  if (s < 1 || H % s != 0 || W % s != 0 || kh < 1 || kw < 1 || K < 1 || C < 1) return -1;
  if (C > 65535) return -2;
  if (mode < MODE_DATA || mode > MODE_BTV) return -3;
  if (mode != MODE_DATA && constants == nullptr) return -4;
  if (mode == MODE_BTV && (btv_range < 1 || btv_range > MAX_BTV_RANGE)) return -5;
  cudaStream_t st = (cudaStream_t)stream;
  return is_double ? launch_gradient<double>(x, r, shifts, blur, kh, kw, K, C, H, W, s, mode,
                                             constants, btv_range, btv_decay, grad,
                                             reg_partials, st)
                   : launch_gradient<float>(x, r, shifts, blur, kh, kw, K, C, H, W, s, mode,
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
