// Mamba-2 SSD (state-space duality) chunk scan for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/ssd/kernel.py::ssd_pallas (body
// _kernel) and its padding wrapper ops.py::ssd_chunked; in the model it is
// the twin of models/layers.py::ssd_jax.  Per sequence b and head h, over
// chunks of L steps with cum the in-chunk cumulative sum of the log-decay a:
//
//   intra:  Y  = ((C Bᵀ) ⊙ M) X           M_ts = exp(cum_t - cum_s) [t >= s]
//   inter:  Y += exp(cum_t) (C h)
//   state:  h  = exp(cum_L) h + Σ_s exp(cum_L - cum_s) B_s x_sᵀ
//
// with h (ds, dh) in float32, zero at the first chunk.  x, b, c are float or
// bfloat16 and read as float32; y is written in x's type.
//
// Layout: x/y (B, T, nh, dh), b/c (B, T, G, ds), a (B, T, nh) float32, the
// final state (B, nh, ds, dh) float32 (optional).  Head h reads the b/c of
// group h / (nh / G) directly: the reference's jnp.repeat is never
// materialised.
//
// What bounds it: per chunk, L(L+1)/2·(ds + dh) multiply-adds in the two
// causal products and 2·L·ds·dh in the carry-in and the state update,
// against ~2·(dh + ds) bytes a step: operations, not bytes (at L = ds = 128,
// dh = 64, 7.36 MFLOP per chunk).  This kernel runs them as float32 FMAs on the CUDA cores from
// shared memory, each thread on a register tile of up to 4x4 outputs so
// that a shared-memory load feeds several FMAs; wgmma on bf16 tiles is the
// later lever.  Design:
//
// * The TPU kernel carries h in scratch across a sequential chunk axis.
//   CUDA CTAs run in no order, so one CTA per (b, h) walks its chunks in
//   ascending order and keeps h in shared memory: no cross-CTA carry, no
//   atomics.
// * The float32 working set of a chunk (h, b, c, x and the L x L scores) is
//   256 KB at full width, above a CTA's 227 KB.  The scores and c are
//   processed kRows rows at a time, both stored transposed for vector
//   reads: h (ds x dh), b (L x ds+1), x (L x dh), c and the scores of kRows
//   rows, cum and the chunk-end weights stay (170 KB at full width,
//   dynamic shared memory).  L is padded to a multiple of kRows with zero
//   rows.
// * The decay exponent is masked before the exp (only s <= t is computed,
//   and score tiles wholly above the diagonal are skipped): exp(cum_t -
//   cum_s) for s > t can overflow, and inf * 0 is NaN.
// * T need not be a multiple of L: steps past T are loaded as x = b = c = 0
//   and a = 0, so they leave h unchanged, and their y is not written.
//
// The wrapper takes dh and ds multiples of 4.  Build without
// --use_fast_math (expf, not __expf).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 512;
constexpr int kRows = 32;          // score rows per pass
constexpr int kT = kRows + 4;      // row stride of the transposed c and scores

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <class T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

// grid (nh, B), block kThreads.  L is the chunk, Lp = L rounded up to kRows.
template <class T>
__global__ void __launch_bounds__(kThreads)
ssd_scan_kernel(const T* __restrict__ x, const T* __restrict__ b, const T* __restrict__ c,
                const float* __restrict__ a, T* __restrict__ y, float* __restrict__ h_last,
                int64_t T_len, int nh, int groups, int dh, int ds, int L, int Lp) {
  extern __shared__ __align__(16) float smem[];
  const int bstride = ds + 1;                // odd: column reads conflict-free
  float* hs = smem;                          // ds x dh    state
  float* bs = hs + ds * dh;                  // Lp x (ds+1)
  float* xs = bs + Lp * bstride;             // Lp x dh
  float* cT = xs + Lp * dh;                  // ds x kT    c of the row pass, transposed
  float* sT = cT + ds * kT;                  // Lp x kT    masked scores, transposed
  float* cum = sT + Lp * kT;                 // Lp
  float* wdec = cum + Lp;                    // Lp         exp(cum_L - cum_s)
  const int h = blockIdx.x;
  const int64_t bb = blockIdx.y;
  const int g = h / (nh / groups);
  const int tid = threadIdx.x;
  const int ndg = dh / 4;                    // column groups of 4

  for (int i = tid; i < ds * dh; i += kThreads) hs[i] = 0.0f;
  const int64_t nchunks = (T_len + L - 1) / L;
  for (int64_t ch = 0; ch < nchunks; ++ch) {
    const int64_t t0 = ch * L;
    __syncthreads();  // the previous chunk's state update is complete
    for (int i = tid; i < Lp * dh; i += kThreads) {
      const int r = i / dh;
      const int e = i - r * dh;
      const int64_t t = t0 + r;
      xs[i] = r < L && t < T_len ? to_f32(x[((bb * T_len + t) * nh + h) * dh + e]) : 0.0f;
    }
    for (int i = tid; i < Lp * ds; i += kThreads) {
      const int r = i / ds;
      const int k = i - r * ds;
      const int64_t t = t0 + r;
      bs[r * bstride + k] =
          r < L && t < T_len ? to_f32(b[((bb * T_len + t) * groups + g) * ds + k]) : 0.0f;
    }
    for (int i = tid; i < Lp; i += kThreads) {
      const int64_t t = t0 + i;
      cum[i] = i < L && t < T_len ? a[(bb * T_len + t) * nh + h] : 0.0f;
    }
    __syncthreads();
    if (tid == 0) {
      float run = 0.0f;
      for (int r = 0; r < Lp; ++r) {
        run += cum[r];
        cum[r] = run;
      }
    }
    __syncthreads();
    const float cum_last = cum[L - 1];
    for (int i = tid; i < Lp; i += kThreads) wdec[i] = expf(cum_last - cum[i]);

    for (int r0 = 0; r0 < Lp; r0 += kRows) {
      __syncthreads();  // the previous pass is done with cT and sT
      for (int i = tid; i < kRows * ds; i += kThreads) {
        const int rr = i / ds;
        const int k = i - rr * ds;
        const int r = r0 + rr;
        const int64_t t = t0 + r;
        cT[k * kT + rr] =
            r < L && t < T_len ? to_f32(c[((bb * T_len + t) * groups + g) * ds + k]) : 0.0f;
      }
      __syncthreads();
      // masked scores, tiles of 4 rows x 2 columns:
      // sT[s][t] = (c_t . b_s) exp(cum_t - cum_s) for s <= t, else 0
      for (int item = tid; item < 4 * Lp; item += kThreads) {
        const int ti = 4 * (item & 7);
        const int s0 = 2 * (item >> 3);
        float acc[4][2] = {};
        if (s0 <= r0 + ti + 3) {
          for (int k = 0; k < ds; ++k) {
            const float4 cv = *reinterpret_cast<const float4*>(cT + k * kT + ti);
            const float cc[4] = {cv.x, cv.y, cv.z, cv.w};
            const float bv[2] = {bs[s0 * bstride + k], bs[(s0 + 1) * bstride + k]};
#pragma unroll
            for (int i = 0; i < 4; ++i)
#pragma unroll
              for (int j = 0; j < 2; ++j) acc[i][j] = fmaf(cc[i], bv[j], acc[i][j]);
          }
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int t = r0 + ti + i;
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            const int s = s0 + j;
            sT[s * kT + ti + i] = s <= t ? acc[i][j] * expf(cum[t] - cum[s]) : 0.0f;
          }
        }
      }
      __syncthreads();
      // y rows, tiles of 1 row x 4 columns: intra-chunk product plus the
      // carry-in of h
      for (int item = tid; item < kRows * ndg; item += kThreads) {
        const int d0 = 4 * (item % ndg);
        const int ti = item / ndg;
        const int r = r0 + ti;
        float yi[4] = {}, yc[4] = {};
        for (int s = 0; s <= r; ++s) {          // sT is 0 past the diagonal
          const float sv = sT[s * kT + ti];
          const float4 xv = *reinterpret_cast<const float4*>(xs + s * dh + d0);
          yi[0] = fmaf(sv, xv.x, yi[0]);
          yi[1] = fmaf(sv, xv.y, yi[1]);
          yi[2] = fmaf(sv, xv.z, yi[2]);
          yi[3] = fmaf(sv, xv.w, yi[3]);
        }
        for (int k = 0; k < ds; ++k) {
          const float cv = cT[k * kT + ti];
          const float4 hv = *reinterpret_cast<const float4*>(hs + k * dh + d0);
          yc[0] = fmaf(cv, hv.x, yc[0]);
          yc[1] = fmaf(cv, hv.y, yc[1]);
          yc[2] = fmaf(cv, hv.z, yc[2]);
          yc[3] = fmaf(cv, hv.w, yc[3]);
        }
        const int64_t tg = t0 + r;
        if (r < L && tg < T_len) {
          const float dec = expf(cum[r]);
          T* yr = y + ((bb * T_len + tg) * nh + h) * dh + d0;
#pragma unroll
          for (int j = 0; j < 4; ++j) yr[j] = from_f32<T>(yi[j] + dec * yc[j]);
        }
      }
    }
    __syncthreads();  // every row has read h_in
    // state update, tiles of 4 x 4: h = exp(cum_L) h + sum_s w_s b_s x_s^T
    const float d_last = expf(cum_last);
    for (int item = tid; item < (ds / 4) * ndg; item += kThreads) {
      const int d0 = 4 * (item % ndg);
      const int k0 = 4 * (item / ndg);
      float acc[4][4] = {};
      for (int s = 0; s < L; ++s) {
        const float w = wdec[s];
        const float4 xv = *reinterpret_cast<const float4*>(xs + s * dh + d0);
        const float xx[4] = {xv.x, xv.y, xv.z, xv.w};
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float bw = w * bs[s * bstride + k0 + i];
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(bw, xx[j], acc[i][j]);
        }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          float* hp = hs + (k0 + i) * dh + d0 + j;
          *hp = d_last * *hp + acc[i][j];
        }
    }
  }
  if (h_last != nullptr) {
    __syncthreads();
    float* out = h_last + (bb * nh + h) * static_cast<int64_t>(ds) * dh;
    for (int i = tid; i < ds * dh; i += kThreads) out[i] = hs[i];
  }
}

template <class T>
cudaError_t launch(const void* x, const void* b, const void* c, const float* a, void* y,
                   float* h_last, int64_t B, int64_t T_len, int64_t nh, int64_t groups,
                   int64_t dh, int64_t ds, int64_t L, cudaStream_t stream) {
  const int64_t Lp = (L + kRows - 1) / kRows * kRows;
  const size_t smem = sizeof(float) * static_cast<size_t>(
      ds * dh + Lp * (ds + 1) + Lp * dh + ds * kT + Lp * kT + 2 * Lp);
  auto kernel = ssd_scan_kernel<T>;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  const dim3 grid(static_cast<unsigned>(nh), static_cast<unsigned>(B));
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(b), static_cast<const T*>(c), a,
      static_cast<T*>(y), h_last, T_len, static_cast<int>(nh), static_cast<int>(groups),
      static_cast<int>(dh), static_cast<int>(ds), static_cast<int>(L), static_cast<int>(Lp));
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype 0: float32, 1: bfloat16 (x, b, c, y alike; a float32).  x/y
// (B, T, nh, dh), b/c (B, T, G, ds), a (B, T, nh), h_last (B, nh, ds, dh)
// float32 or null; all contiguous on the current device; launched on
// `stream`.  L is the chunk length (<= T).  Returns cudaErrorInvalidValue
// for nh % G != 0 or dh, ds not multiples of 4, the error of the launch for
// B > 65535 or a working set above a CTA's shared memory, else
// cudaGetLastError() after the launch (0 on success).
int ssd_scan(int dtype, const void* x, const void* b, const void* c, const void* a, void* y,
             void* h_last, int64_t B, int64_t T_len, int64_t nh, int64_t groups, int64_t dh,
             int64_t ds, int64_t L, void* stream) {
  if (B == 0 || nh == 0) return cudaSuccess;
  if (T_len <= 0 || L <= 0 || groups <= 0 || nh % groups || dh % 4 || ds % 4) {
    return cudaErrorInvalidValue;
  }
  const auto* av = static_cast<const float*>(a);
  auto* hv = static_cast<float*>(h_last);
  const auto s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return launch<float>(x, b, c, av, y, hv, B, T_len, nh, groups, dh, ds, L, s);
    case 1: return launch<__nv_bfloat16>(x, b, c, av, y, hv, B, T_len, nh, groups, dh, ds, L, s);
    default: return cudaErrorInvalidValue;
  }
}

const char* ssd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
