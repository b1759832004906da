// Row-layout semiring SpMV for Hopper (sm_90a), batched over machines.
//
// Replaces nothing of the JAX package.  The TPU kernel
// src/repro/kernels/bsr_spmv/kernel.py::spmv_pallas reads dense Block-ELL
// blocks, and its counterpart here is csrc/bsr_spmv.cu, which the tests
// keep holding against it.  This kernel computes the same product over a
// layout whose bytes follow the edges (rows.py, bsp/partition_runtime.py
// LocalRows): for every machine m and row r of its degree-ranked rows,
//
//   y[m, r] = (+)_{(c, a) in row r}  a (x) x[m, c]
//
// under (+,x) (semiring 0), (min,+) (semiring 1) or (or,and) over 0/1 floats
// (semiring 2).  An empty row is the semiring's zero: 0, +inf, 0.
//
// The layout.  Entries are (column id, value) pairs, int32 and the message
// type T, in two arrays; a table of work units says who reads what.  A unit
// is 16 bytes: the int64 offset of its first entry, its first row as m*n + r
// (int32), and its kind (the top two bits) with its length:
//
// * SLICE: 32 consecutive rows, one lane a row; entry k of the slice's lane
//   l at offset + 32*k + l (column-major, so a warp's loads coalesce), the
//   length being the slice's longest row; a shorter row is padded with
//   column -1, which the kernel skips;
// * ROW: one row, `length` entries from offset, one warp;
// * CTA: one row, `length` entries from offset, the CTA's 8 warps: the
//   table holds it 8 times, at a multiple of 8, so that a CTA's warps all
//   take it;
// * FILL: `length` rows from the first, all empty: they get the zero.
//
// Within a row, entries ascend by column.  Every row of every machine is in
// exactly one unit; each warp reads its unit table entry, so one launch
// covers all machines whatever their sizes, and no padding rows exist.
//
// What bounds it: every entry is read once (4 bytes of column id and the
// value), x once from device memory and then from the caches, y written
// once: at the graph path's size (graph500:16 over p = 9) 1.82 M directed
// entries, about 16.9 MB in float32 with x and y, against 3.35 TB/s.  So
// the kernel is bound by bytes and by the latency of dependent loads (the
// column id, then x at that column).  x of one machine is at most
// 4 * Vmax bytes (128 KB at graph500:16), read through the read-only
// cache (__ldg) and L2, not once an entry from device memory.
//
// Skew: degrees are power-law (one row of 2,274 entries, medians of 3 to
// 34).  LocalRows.build ranks rows by degree, so the long rows are a
// prefix of each machine.  A row longer than 256 entries is a CTA's: 256
// threads stride it, reduce by xor shuffles in each warp, then through
// shared memory in warp order.  A row of 33 to 256 entries (and any shorter
// one inside the long prefix) is a warp's: lanes stride it and reduce by
// xor shuffles.  The rest, at most 32 entries a row, go in SLICEs of 32
// rows, one lane a row; the rows of a slice have nearly the same degree, so
// their padding is small (0.25 % of the entries at graph500:16).
//
// Rounding.  Products are taken in float32 on values widened from T;
// nothing is computed in 16-bit arithmetic.  Under (min,+) and (or,and) the
// min/max of the float32 products is rounded once to T: the same value as
// the dense kernel's, bitwise, since rounding is monotone.  Float32 (+,x)
// sums in float32 in the fixed order of each unit.  16-bit (+,x) keeps the
// dense kernel's contract (ref.plus_times_bounds): the entries of each
// `bm`-wide column group (the dense layout's block column) are summed in
// float32, the sum is rounded once to T and folded into y, held in T, in
// ascending group order.  A lane does that along its row; a warp runs its
// row 32 entries at a time, sums each group's lanes by a segmented scan and
// folds the groups in order; a CTA row in 16-bit (+,x) is its first warp's
// alone, since the fold over groups is one sequence.
//
// No atomics and no order that depends on timing: a result repeats bit for
// bit from run to run.  Nothing synchronises beyond a CTA row's one
// __syncthreads, and nothing allocates, so a CUDA graph may capture the
// launch.  bsr_spmv_rows_init loads every instance once (outside any
// capture).  Build without --use_fast_math (see csrc/bsr_spmv.cu).
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;                 // warps a CTA
constexpr int kThreads = kWarps * 32;
constexpr uint32_t kLenMask = 0x3fffffffu;
enum Kind : uint32_t { kSlice = 0, kRow = 1, kCta = 2, kFill = 3 };

template <class T>
struct Store;

template <>
struct Store<float> {
  static constexpr bool kNarrow = false;
  static __device__ __forceinline__ float to_float(float v) { return v; }
  static __device__ __forceinline__ float round(float v) { return v; }
  static __device__ __forceinline__ float from_float(float v) { return v; }
};

template <>
struct Store<__nv_bfloat16> {
  static constexpr bool kNarrow = true;
  static __device__ __forceinline__ float to_float(__nv_bfloat16 v) {
    return __bfloat162float(v);
  }
  static __device__ __forceinline__ float round(float v) {
    return __bfloat162float(__float2bfloat16_rn(v));
  }
  static __device__ __forceinline__ __nv_bfloat16 from_float(float v) {
    return __float2bfloat16_rn(v);
  }
};

template <>
struct Store<__half> {
  static constexpr bool kNarrow = true;
  static __device__ __forceinline__ float to_float(__half v) { return __half2float(v); }
  static __device__ __forceinline__ float round(float v) {
    return __half2float(__float2half_rn(v));
  }
  static __device__ __forceinline__ __half from_float(float v) { return __float2half_rn(v); }
};

struct PlusTimes {
  static constexpr bool kSum = true;
  static __device__ __forceinline__ float zero() { return 0.0f; }
  static __device__ __forceinline__ float times(float a, float x) { return a * x; }
  static __device__ __forceinline__ float plus(float a, float b) { return a + b; }
};

// min and max propagate NaN, as csrc/bsr_spmv.cu's do
struct MinPlus {
  static constexpr bool kSum = false;
  static __device__ __forceinline__ float zero() { return __int_as_float(0x7f800000); }
  static __device__ __forceinline__ float times(float a, float x) { return a + x; }
  static __device__ __forceinline__ float plus(float a, float b) {
    return (a < b || a != a) ? a : b;
  }
};

struct OrAnd {
  static constexpr bool kSum = false;
  static __device__ __forceinline__ float zero() { return 0.0f; }
  static __device__ __forceinline__ float times(float a, float x) { return a * x; }
  static __device__ __forceinline__ float plus(float a, float b) {
    return (a > b || a != a) ? a : b;
  }
};

// 16-bit (+,x): fold a group's float32 sum into y, one rounding each
template <class T>
__device__ __forceinline__ float fold(float yv, float sum) {
  return Store<T>::round(yv + Store<T>::round(sum));
}

template <class S, class T>
__device__ __forceinline__ float product(const int32_t* __restrict__ cols,
                                         const T* __restrict__ vals, const T* __restrict__ xm,
                                         int64_t e) {
  return S::times(Store<T>::to_float(vals[e]), Store<T>::to_float(__ldg(xm + __ldg(cols + e))));
}

// A warp's row, `len` entries from e0: all lanes return its value.
template <class S, class T>
__device__ float warp_row(const int32_t* __restrict__ cols, const T* __restrict__ vals,
                          const T* __restrict__ xm, int64_t e0, int64_t len, int bm, int lane) {
  constexpr bool kSlotSum = S::kSum && Store<T>::kNarrow;
  if constexpr (!kSlotSum) {
    float acc = S::zero();
#pragma unroll 4
    for (int64_t e = lane; e < len; e += 32) {
      acc = S::plus(acc, product<S, T>(cols, vals, xm, e0 + e));
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      acc = S::plus(acc, __shfl_xor_sync(0xffffffffu, acc, off));
    }
    return acc;
  } else {
    // 32 entries at a time: each lane's product and column group; a
    // segmented scan sums each group's lanes; the groups ending in this
    // chunk fold into y in order, and the last one carries over when the
    // next chunk may continue it.  The next chunk's column ids and values
    // are loaded before this chunk's x, scan and fold.
    float yv = 0.0f;
    float carry = 0.0f;
    int carry_g = -1;
    int next_c = 0;
    T next_a = Store<T>::from_float(0.0f);
    if (lane < len) {
      next_c = __ldg(cols + e0 + lane);
      next_a = vals[e0 + lane];
    }
    for (int64_t base = 0; base < len; base += 32) {
      const bool valid = base + lane < len;
      const int c = next_c;
      const T a = next_a;
      if (base + 32 + lane < len) {
        next_c = __ldg(cols + e0 + base + 32 + lane);
        next_a = vals[e0 + base + 32 + lane];
      }
      float v = 0.0f;
      int g = 0x7fffffff;
      if (valid) {
        v = S::times(Store<T>::to_float(a), Store<T>::to_float(__ldg(xm + c)));
        g = c / bm;
      }
#pragma unroll
      for (int d = 1; d < 32; d <<= 1) {
        const float o = __shfl_up_sync(0xffffffffu, v, d);
        const int og = __shfl_up_sync(0xffffffffu, g, d);
        if (lane >= d && og == g) v += o;
      }
      const int next_g = __shfl_down_sync(0xffffffffu, g, 1);
      const bool ends = valid && (lane == 31 || next_g != g);
      unsigned ends_mask = __ballot_sync(0xffffffffu, ends);
      const bool more = base + 32 < len;
      while (ends_mask) {
        const int l = __ffs(ends_mask) - 1;
        ends_mask &= ends_mask - 1;
        float s = __shfl_sync(0xffffffffu, v, l);
        const int gl = __shfl_sync(0xffffffffu, g, l);
        if (carry_g >= 0) {
          if (gl == carry_g) {
            s = carry + s;
          } else {
            yv = fold<T>(yv, carry);
          }
          carry_g = -1;
        }
        if (l == 31 && more) {
          carry = s;
          carry_g = gl;
        } else {
          yv = fold<T>(yv, s);
        }
      }
    }
    return yv;
  }
}

template <class S, class T>
__global__ void __launch_bounds__(kThreads)
bsr_spmv_rows_kernel(const int4* __restrict__ units, int64_t n_units,
                     const int32_t* __restrict__ cols, const T* __restrict__ vals,
                     const T* __restrict__ x, T* __restrict__ y, int64_t n, int bm) {
  using St = Store<T>;
  constexpr bool kSlotSum = S::kSum && St::kNarrow;
  __shared__ float warp_part[kWarps];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int64_t u = static_cast<int64_t>(blockIdx.x) * kWarps + warp;
  if (u >= n_units) return;   // never inside a CTA row: those fill their 8 entries
  const int4 unit = __ldg(units + u);
  const int64_t off = static_cast<int64_t>(static_cast<uint32_t>(unit.x)) |
                      (static_cast<int64_t>(unit.y) << 32);
  const int64_t row = unit.z;                       // m*n + r
  const uint32_t kind = static_cast<uint32_t>(unit.w) >> 30;
  const int64_t len = static_cast<uint32_t>(unit.w) & kLenMask;
  const int64_t m = row / n;
  const T* xm = x + m * n;

  if (kind == kSlice) {
    const int64_t e0 = off + lane;
    float acc = S::zero();    // (+,x) in float32, (min,+), (or,and)
    float part = 0.0f;        // 16-bit (+,x): the open group's sum
    int cg = -1;              // and its group
#pragma unroll 4
    for (int64_t k = 0; k < len; ++k) {
      const int64_t e = e0 + 32 * k;
      const int c = __ldg(cols + e);
      if (c >= 0) {
        const float p = S::times(St::to_float(vals[e]), St::to_float(__ldg(xm + c)));
        if constexpr (kSlotSum) {
          const int g = c / bm;
          if (g != cg) {
            if (cg >= 0) acc = fold<T>(acc, part);
            part = 0.0f;
            cg = g;
          }
          part += p;
        } else {
          acc = S::plus(acc, p);
        }
      }
    }
    if constexpr (kSlotSum) {
      if (cg >= 0) acc = fold<T>(acc, part);
    }
    if (row - m * n + lane < n) y[row + lane] = St::from_float(acc);
  } else if (kind == kRow) {
    const float v = warp_row<S, T>(cols, vals, xm, off, len, bm, lane);
    if (lane == 0) y[row] = St::from_float(v);
  } else if (kind == kCta) {
    if constexpr (kSlotSum) {
      if (warp != 0) return;
      const float v = warp_row<S, T>(cols, vals, xm, off, len, bm, lane);
      if (lane == 0) y[row] = St::from_float(v);
    } else {
      float acc = S::zero();
#pragma unroll 4
      for (int64_t e = threadIdx.x; e < len; e += kThreads) {
        acc = S::plus(acc, product<S, T>(cols, vals, xm, off + e));
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) acc = S::plus(acc, __shfl_xor_sync(0xffffffffu, acc, o));
      if (lane == 0) warp_part[warp] = acc;
      __syncthreads();
      if (threadIdx.x == 0) {
        float v = warp_part[0];
#pragma unroll
        for (int w = 1; w < kWarps; ++w) v = S::plus(v, warp_part[w]);
        y[row] = St::from_float(v);
      }
    }
  } else {
    const T zero = St::from_float(S::zero());
    for (int64_t r = lane; r < len; r += 32) y[row + r] = zero;
  }
}

// f(the instance for (storage type T, semiring))
template <class T, class F>
cudaError_t with_kernel(int64_t semiring, F&& f) {
  switch (semiring) {
    case 0: return f(bsr_spmv_rows_kernel<PlusTimes, T>);
    case 1: return f(bsr_spmv_rows_kernel<MinPlus, T>);
    case 2: return f(bsr_spmv_rows_kernel<OrAnd, T>);
    default: return cudaErrorInvalidValue;
  }
}

template <class T>
int run(const void* units, int64_t n_units, const void* cols, const void* vals, const void* x,
        void* y, int64_t n, int64_t bm, int64_t semiring, void* stream) {
  if (n_units < 0 || n < 1 || bm < 1 || bm > 0x7fffffff) return cudaErrorInvalidValue;
  if (reinterpret_cast<uintptr_t>(units) % 16) return cudaErrorMisalignedAddress;
  if (n_units == 0) return cudaSuccess;
  const int64_t ctas = (n_units + kWarps - 1) / kWarps;
  if (ctas > 0x7fffffff) return cudaErrorInvalidValue;
  const auto s = static_cast<cudaStream_t>(stream);
  return with_kernel<T>(semiring, [&](auto kernel) {
    kernel<<<static_cast<unsigned>(ctas), kThreads, 0, s>>>(
        static_cast<const int4*>(units), n_units, static_cast<const int32_t*>(cols),
        static_cast<const T*>(vals), static_cast<const T*>(x), static_cast<T*>(y), n,
        static_cast<int>(bm));
    return cudaGetLastError();
  });
}

template <class T>
cudaError_t load_all() {
  for (int64_t sr = 0; sr < 3; ++sr) {
    const cudaError_t err = with_kernel<T>(sr, [](auto kernel) {
      cudaFuncAttributes attr;
      return cudaFuncGetAttributes(&attr, kernel);
    });
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}

}  // namespace

extern "C" {

// units (U, 4) int32 (16-byte aligned), cols (N,) int32, vals (N,) T,
// x (p, n) T -> y (p, n) T, all contiguous on the current device, launched
// on `stream`; bm is the column group of 16-bit (+,x).  Returns
// cudaGetLastError() after the launch (0 on success), or an error without
// launching.  bsr_spmv_rows_init must have run on the device.
#define BSR_SPMV_ROWS_ENTRY(name, T)                                                        \
  int name(const void* units, int64_t n_units, const void* cols, const void* vals,          \
           const void* x, void* y, int64_t n, int64_t bm, int64_t semiring, void* stream) { \
    return run<T>(units, n_units, cols, vals, x, y, n, bm, semiring, stream);               \
  }

BSR_SPMV_ROWS_ENTRY(bsr_spmv_rows_f32, float)
BSR_SPMV_ROWS_ENTRY(bsr_spmv_rows_bf16, __nv_bfloat16)
BSR_SPMV_ROWS_ENTRY(bsr_spmv_rows_f16, __half)

// Load every instance on the current device, so that no launch (under a
// CUDA graph's capture either) loads a module.  Once a device, outside any
// capture.
int bsr_spmv_rows_init() {
  cudaError_t err = load_all<float>();
  if (err == cudaSuccess) err = load_all<__nv_bfloat16>();
  if (err == cudaSuccess) err = load_all<__half>();
  return err;
}

const char* bsr_spmv_rows_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
