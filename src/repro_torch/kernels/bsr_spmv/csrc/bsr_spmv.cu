// Block-ELL semiring SpMV for Hopper (sm_90a), batched over machines.
//
// Replaces the TPU kernel src/repro/kernels/bsr_spmv/kernel.py::spmv_pallas
// (body _make_kernel), in each of its storage types (float32, bfloat16,
// float16: the message dtype of the BSP backends).  For every machine m and
// block-row r:
//
//   y[m, r*bm + i] = (+)_k (+)_j  blocks[m, r, k, i, j] (x) x[m, cols[m, r, k]*bm + j]
//
// under (+,x) (semiring 0), (min,+) (semiring 1) or (or,and) over 0/1 floats
// (semiring 2).  y starts at the semiring's zero: 0, +inf, 0.  Padding ELL
// slots point at block-column 0 and hold `absent` blocks, whose products are
// the zero by the annihilator property.
//
// Rounding follows the reference's Pallas body.  In float32 everything is
// float32.  In a 16-bit type T, (+,x) takes each ELL slot's products and
// their row sum in float32 (the reference's jnp.dot with
// preferred_element_type), rounds that sum once to T, and folds it into a y
// held in T in ascending k, one rounding per slot.  (min,+) and (or,and)
// round each product a (x) x once to T and fold with min/max; rounding is
// monotone, so the min/max of the float32 products rounded once at the end
// is the same value, and that is what the kernel computes.  Blocks and x are
// widened to float32 in registers; nothing is computed in 16-bit
// arithmetic.
//
// What bounds it: every block cell is read once and used once, so the work
// is p*R*K*bm^2 loads and as many semiring ops; at the graph path's size
// (p=9, R=K=251, bm=128) that is 37.2 GB in float32 and 18.6 GB in a 16-bit
// type against 3.35 TB/s of HBM, while the products take a twentieth of
// that time at the float32 CUDA-core rate.  The kernel is bandwidth-bound,
// and its design aims only at keeping enough bytes in flight to stream the
// blocks at the card's rate:
//
// * work item: (machine m, block-row r, a tile of `rows` of the bm rows).
//   The tile's rows of one block (m, r, k) are one contiguous run of
//   rows*bm elements, and its x slice x[m, cols*bm : +bm] is another.  One
//   CTA a tile (grid p*R*ceil(bm/rows), one dimension); the K loop runs
//   inside the CTA in ascending k, and no CTA touches another's y (no
//   atomics, no split-K), which the 16-bit rounding contract needs;
// * a ring of `stages` stages in dynamic shared memory, each holding one
//   slot's block slab and its x slice, with a "full" and an "empty"
//   mbarrier a stage.  One producer warp fills it; the consumer warps drain
//   it.  There is no __syncthreads inside the K loop: the stream of blocks
//   never drains to a barrier;
// * the producer loads the tile's column ids 32 slots at a time, one batch
//   ahead, into registers and hands each to its copy by a shuffle, so no x
//   copy waits on a dependent load.  Bulk mode (the row of a block is a
//   multiple of 16 bytes and blocks and x are 16-byte aligned): one lane
//   issues two 1-D bulk copies a stage (cp.async.bulk ... complete_tx), the
//   slab with an L2 evict-first hint, which complete on the stage's full
//   barrier.  Loads mode (any other shape, e.g. bm = 30 in 16 bits): the
//   producer's 32 lanes copy the stage with their own loads and each
//   arrives on the full barrier.  The consumers are the same in both;
// * consumers: `lanes` threads (1, 2 or 4) own an output row.  Each sums
//   its share of the row's products for a slot in float32, in four
//   independent accumulators, reading 16-byte vectors from shared memory
//   (single values where a block row is no multiple of 16 bytes);
//   the lanes of a row join with at most two xor shuffles.  Rows lie
//   bm*sizeof(T) bytes apart, 128 bytes' multiple at bm = 128, so every row
//   starts in the same bank: each thread walks its row rotated (vector
//   (lanes*w + h + lanes*row) mod W), so the 8 threads of a 128-bit phase
//   read distinct banks.  16-bit (+,x) rounds the slot's row sum once and
//   folds it into y; the other instances fold into their accumulators and
//   combine them once, after the last slot.  A warp releases a stage by one
//   arrive on its empty barrier after a __syncwarp;
// * the tile plan comes from the caller (kernel.py::plan_tiles), which
//   owns the ring's layout: rows, lanes, stages, mode, the x slice's offset
//   in a stage, the stage stride, the threads and the dynamic shared
//   memory, the stages' full and empty barriers after the last stage.  This
//   file refuses a plan whose layout does not hold a slab, an x slice and
//   the barriers, and reports the CTAs an SM holds for a plan
//   (bsr_spmv_occupancy).  A ring above 48 KB needs the kernel's dynamic
//   shared-memory limit raised: bsr_spmv_init raises it for every instance
//   once, to what the device allows a block, and returns that limit, so a
//   launch (under a CUDA graph's capture too) makes no attribute call;
// * every offset is int64: p*R*K*bm^2 is 9.3e9 elements at the graph path's
//   size.
//
// The reassociation inside a slot, and across slots outside 16-bit (+,x),
// changes only the float32 order of a sum (with a*x+acc contracted to an
// FMA): float32 (+,x) is held at rtol 1e-5 and 16-bit (+,x) inside
// ref.plus_times_bounds, which admits any order; (min,+) and (or,and) are
// exact in any order.
//
// Build without --use_fast_math: flush-to-zero and relaxed inf/NaN handling
// would break the bitwise (min,+) contract and float16 subnormals and
// overflow to inf.  No tensor cores: mma sums do not follow IEEE float32
// rounding, which the 16-bit contract relies on, and the products are not
// the bound.
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxConsumers = 128;                // consumer threads a CTA
constexpr int kMaxThreads = kMaxConsumers + 32;   // and the producer warp
constexpr int kAcc = 4;           // independent float32 accumulators a thread

// Storage types: widen to float32 (one value, or the values of a 16-byte
// vector), round a float32 to the type (returned as the float32 it
// represents), and store.
template <class T>
struct Store;

template <>
struct Store<float> {
  static constexpr bool kNarrow = false;
  static constexpr int kVec = 4;
  using Bits = uint32_t;
  static __device__ __forceinline__ float to_float(float v) { return v; }
  static __device__ __forceinline__ float round(float v) { return v; }
  static __device__ __forceinline__ float from_float(float v) { return v; }
  static __device__ __forceinline__ void widen(const uint4& u, float (&f)[kVec]) {
    f[0] = __uint_as_float(u.x);
    f[1] = __uint_as_float(u.y);
    f[2] = __uint_as_float(u.z);
    f[3] = __uint_as_float(u.w);
  }
};

template <>
struct Store<__nv_bfloat16> {
  static constexpr bool kNarrow = true;
  static constexpr int kVec = 8;
  using Bits = uint16_t;
  static __device__ __forceinline__ float to_float(__nv_bfloat16 v) {
    return __bfloat162float(v);
  }
  static __device__ __forceinline__ float round(float v) {
    return __bfloat162float(__float2bfloat16_rn(v));
  }
  static __device__ __forceinline__ __nv_bfloat16 from_float(float v) {
    return __float2bfloat16_rn(v);
  }
  // a bfloat16 is the upper half of the float32 with the same bits; the
  // lower half of a 32-bit word is the first value
  static __device__ __forceinline__ void widen2(uint32_t w, float& lo, float& hi) {
    lo = __uint_as_float(w << 16);
    hi = __uint_as_float(w & 0xffff0000u);
  }
  static __device__ __forceinline__ void widen(const uint4& u, float (&f)[kVec]) {
    widen2(u.x, f[0], f[1]);
    widen2(u.y, f[2], f[3]);
    widen2(u.z, f[4], f[5]);
    widen2(u.w, f[6], f[7]);
  }
};

template <>
struct Store<__half> {
  static constexpr bool kNarrow = true;
  static constexpr int kVec = 8;
  using Bits = uint16_t;
  static __device__ __forceinline__ float to_float(__half v) { return __half2float(v); }
  static __device__ __forceinline__ float round(float v) {
    return __half2float(__float2half_rn(v));
  }
  static __device__ __forceinline__ __half from_float(float v) { return __float2half_rn(v); }
  static __device__ __forceinline__ void widen2(uint32_t w, float& lo, float& hi) {
    const float2 f = __half22float2(*reinterpret_cast<const __half2*>(&w));
    lo = f.x;
    hi = f.y;
  }
  static __device__ __forceinline__ void widen(const uint4& u, float (&f)[kVec]) {
    widen2(u.x, f[0], f[1]);
    widen2(u.y, f[2], f[3]);
    widen2(u.z, f[4], f[5]);
    widen2(u.w, f[6], f[7]);
  }
};

struct PlusTimes {
  static constexpr bool kSum = true;
  static __device__ __forceinline__ float zero() { return 0.0f; }
  static __device__ __forceinline__ float times(float a, float x) { return a * x; }
  static __device__ __forceinline__ float plus(float a, float b) { return a + b; }
};

// min and max propagate NaN (torch.minimum / jnp.minimum semantics);
// fminf/fmaxf would drop it.
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

// --- mbarriers and bulk copies (PTX) ---------------------------------------

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_addr(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(smem_addr(bar)) : "memory");
}

__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

// wait until the phase of parity `parity` has completed
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_addr(bar);
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n\t.reg .pred p;\n\t"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
        "selp.u32 %0, 1, 0, p;\n\t}"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  }
}

__device__ __forceinline__ uint64_t evict_first_policy() {
  uint64_t policy;
  asm volatile("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;" : "=l"(policy));
  return policy;
}

// 1-D bulk copy global -> shared, completing `bytes` on `bar`; sizes and
// both addresses are multiples of 16 bytes
__device__ __forceinline__ void bulk_copy(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];" ::
          "r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

__device__ __forceinline__ void bulk_copy_hint(void* dst, const void* src, uint32_t bytes,
                                               uint64_t* bar, uint64_t policy) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes.L2::cache_hint"
      " [%0], [%1], %2, [%3], %4;" ::"r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar)), "l"(policy)
      : "memory");
}

// --- the plan ----------------------------------------------------------------

struct Plan {
  int rows;     // rows of a tile
  int lanes;    // threads an output row
  int stages;   // stages of the ring
  int bulk;     // 1: bulk copies; 0: the producer's own loads
  int x_off;    // bytes from a stage's start to its x slice
  int stride;   // bytes from one stage to the next; the barriers follow
                // the last stage
};

// --- the kernel ---------------------------------------------------------------

// The producer warp: fills stage k % stages with slot k's slab and x slice.
template <class T>
__device__ __forceinline__ void produce(const int32_t* __restrict__ cols_r,
                                        const T* __restrict__ slab0, const T* __restrict__ xm,
                                        int64_t K, int64_t bm2, int bm, int tr, const Plan& pl,
                                        unsigned char* ring, uint64_t* full, uint64_t* empty) {
  using Bits = typename Store<T>::Bits;
  const int lane = threadIdx.x & 31;
  const uint32_t slab_bytes = static_cast<uint32_t>(tr) * bm * sizeof(T);
  const uint32_t x_bytes = static_cast<uint32_t>(bm) * sizeof(T);
  const uint64_t policy = pl.bulk ? evict_first_policy() : 0;
  // column ids, 32 slots a batch, the next batch loaded one batch ahead
  int32_t ids = lane < K ? __ldg(cols_r + lane) : 0;
  int32_t next = 32 + lane < K ? __ldg(cols_r + 32 + lane) : 0;
  int s = 0;
  uint32_t phase = 0;
  for (int64_t k = 0; k < K; ++k) {
    if ((k & 31) == 0 && k > 0) {
      ids = next;
      next = k + 32 + lane < K ? __ldg(cols_r + k + 32 + lane) : 0;
    }
    const int32_t col = __shfl_sync(0xffffffffu, ids, static_cast<int>(k & 31));
    mbar_wait(&empty[s], phase ^ 1u);
    unsigned char* st = ring + static_cast<size_t>(s) * pl.stride;
    const T* src_a = slab0 + k * bm2;
    const T* src_x = xm + static_cast<int64_t>(col) * bm;
    if (pl.bulk) {
      if (lane == 0) {
        mbar_arrive_expect_tx(&full[s], slab_bytes + x_bytes);
        bulk_copy_hint(st, src_a, slab_bytes, &full[s], policy);
        bulk_copy(st + pl.x_off, src_x, x_bytes, &full[s]);
      }
    } else {
      const Bits* a = reinterpret_cast<const Bits*>(src_a);
      const Bits* xs = reinterpret_cast<const Bits*>(src_x);
      Bits* da = reinterpret_cast<Bits*>(st);
      Bits* dx = reinterpret_cast<Bits*>(st + pl.x_off);
      const int n = tr * bm;
      for (int e = lane; e < n; e += 32) da[e] = __ldcs(a + e);
      for (int e = lane; e < bm; e += 32) dx[e] = __ldg(xs + e);
      mbar_arrive(&full[s]);   // every lane: its own stores, released
    }
    if (++s == pl.stages) {
      s = 0;
      phase ^= 1u;
    }
  }
}

template <class S, class T, bool kVec>
__global__ void __launch_bounds__(kMaxThreads)
bsr_spmv_kernel(const int32_t* __restrict__ cols, const T* __restrict__ blocks,
                const T* __restrict__ x, T* __restrict__ y, int64_t R, int64_t K, int64_t C,
                int bm, Plan pl) {
  using St = Store<T>;
  // 16-bit (+,x): each slot's row sum is rounded on its own (see the top)
  constexpr bool kSlotSum = S::kSum && St::kNarrow;
  extern __shared__ __align__(128) unsigned char ring[];
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + static_cast<size_t>(pl.stages) * pl.stride);
  uint64_t* empty = full + pl.stages;

  const int row_tiles = (bm + pl.rows - 1) / pl.rows;
  const int64_t mr = blockIdx.x / row_tiles;            // m*R + r
  const int i0 = static_cast<int>(blockIdx.x - mr * row_tiles) * pl.rows;
  const int tr = min(pl.rows, bm - i0);                 // rows of this tile
  const int64_t m = mr / R;
  const int consumers = blockDim.x - 32;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int esize = static_cast<int>(sizeof(T));
  const int64_t bm2 = static_cast<int64_t>(bm) * bm;

  if (threadIdx.x == 0) {
    for (int s = 0; s < pl.stages; ++s) {
      mbar_init(&full[s], pl.bulk ? 1u : 32u);
      mbar_init(&empty[s], static_cast<uint32_t>(consumers / 32));
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();   // the only CTA-wide barrier: before the roles split

  if (warp == consumers / 32) {
    produce<T>(cols + mr * K, blocks + (mr * K * bm + i0) * static_cast<int64_t>(bm),
               x + m * C * bm, K, bm2, bm, tr, pl, ring, full, empty);
    return;
  }

  // consumers: `lanes` threads a row; threads past the tile's rows read its
  // last row and write nothing, so every lane of a warp takes the shuffles
  const int L = pl.lanes;
  const int ri = threadIdx.x / L;
  const int h = threadIdx.x - ri * L;
  const bool live = ri < tr;
  const int row = live ? ri : tr - 1;
  const int W = kVec ? bm * esize / 16 : bm;    // 16-byte vectors (or values) a row
  const int per = W / L;
  const int start = (h + L * row) % W;

  float acc[kAcc];
#pragma unroll
  for (int a = 0; a < kAcc; ++a) acc[a] = S::zero();
  float yv = S::zero();   // 16-bit (+,x): y, a value of T
  int s = 0;
  uint32_t phase = 0;
  for (int64_t k = 0; k < K; ++k) {
    mbar_wait(&full[s], phase);
    const unsigned char* st = ring + static_cast<size_t>(s) * pl.stride;
    float part[kAcc];
#pragma unroll
    for (int a = 0; a < kAcc; ++a) part[a] = kSlotSum ? 0.0f : acc[a];
    int u = start;
    if constexpr (kVec) {
      constexpr int V = St::kVec;
      const uint4* av = reinterpret_cast<const uint4*>(st) + static_cast<size_t>(row) * W;
      const uint4* xv = reinterpret_cast<const uint4*>(st + pl.x_off);
#pragma unroll 2
      for (int w = 0; w < per; ++w) {
        float fa[V], fx[V];
        St::widen(av[u], fa);
        St::widen(xv[u], fx);
#pragma unroll
        for (int e = 0; e < V; ++e) {
          part[e % kAcc] = S::plus(part[e % kAcc], S::times(fa[e], fx[e]));
        }
        u += L;
        if (u >= W) u -= W;
      }
    } else {
      const T* arow = reinterpret_cast<const T*>(st) + static_cast<size_t>(row) * bm;
      const T* xs = reinterpret_cast<const T*>(st + pl.x_off);
      int w = 0;
      for (; w + kAcc <= per; w += kAcc) {
#pragma unroll
        for (int a = 0; a < kAcc; ++a) {
          part[a] = S::plus(part[a], S::times(St::to_float(arow[u]), St::to_float(xs[u])));
          u += L;
          if (u >= W) u -= W;
        }
      }
      for (; w < per; ++w) {
        part[0] = S::plus(part[0], S::times(St::to_float(arow[u]), St::to_float(xs[u])));
        u += L;
        if (u >= W) u -= W;
      }
    }
    if constexpr (kSlotSum) {
      // the slot's row sum in float32, rounded once; the fold rounds once
      float sum = (part[0] + part[1]) + (part[2] + part[3]);
      for (int off = 1; off < L; off <<= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
      yv = St::round(yv + St::round(sum));
    } else {
#pragma unroll
      for (int a = 0; a < kAcc; ++a) acc[a] = part[a];
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[s]);   // this warp is done with the stage
    if (++s == pl.stages) {
      s = 0;
      phase ^= 1u;
    }
  }
  if constexpr (!kSlotSum) {
    yv = S::plus(S::plus(acc[0], acc[1]), S::plus(acc[2], acc[3]));
    for (int off = 1; off < L; off <<= 1) {
      yv = S::plus(yv, __shfl_xor_sync(0xffffffffu, yv, off));
    }
  }
  if (live && h == 0) y[mr * bm + i0 + ri] = St::from_float(yv);
}

// --- host side ------------------------------------------------------------------

// f(the instance for (storage type T, semiring, vector rows or not))
template <class T, class F>
cudaError_t with_kernel(int64_t semiring, bool vec, F&& f) {
  switch (semiring) {
    case 0:
      return vec ? f(bsr_spmv_kernel<PlusTimes, T, true>) : f(bsr_spmv_kernel<PlusTimes, T, false>);
    case 1:
      return vec ? f(bsr_spmv_kernel<MinPlus, T, true>) : f(bsr_spmv_kernel<MinPlus, T, false>);
    case 2:
      return vec ? f(bsr_spmv_kernel<OrAnd, T, true>) : f(bsr_spmv_kernel<OrAnd, T, false>);
    default:
      return cudaErrorInvalidValue;
  }
}

// rows of a block as 16-byte vectors: the bulk copies' and the vector
// consumers' condition
template <class T>
bool vector_rows(int64_t bm) {
  return bm * static_cast<int64_t>(sizeof(T)) % 16 == 0;
}

// 0 if the plan fits the kernel at this bm and storage type, with `threads`
// a CTA and `smem` bytes of dynamic shared memory, else an error: 16-byte
// aligned stages that hold the tile's slab and then its x slice, and room
// for the 2*stages barriers after the last stage
template <class T>
cudaError_t check_plan(const Plan& pl, int64_t bm, int64_t threads, int64_t smem) {
  const bool vec = vector_rows<T>(bm);
  const int64_t esize = sizeof(T);
  const int64_t units = vec ? bm * esize / 16 : bm;
  if (bm < 1 || pl.rows < 1 || pl.rows > bm || pl.stages < 1 ||
      (pl.lanes != 1 && pl.lanes != 2 && pl.lanes != 4) || units % pl.lanes != 0 ||
      threads % 32 != 0 || threads > kMaxThreads || pl.rows * pl.lanes > threads - 32 ||
      (pl.bulk && !vec) || pl.x_off % 16 != 0 || pl.stride % 16 != 0 ||
      pl.x_off < pl.rows * bm * esize || pl.stride < pl.x_off + bm * esize ||
      smem < static_cast<int64_t>(pl.stages) * (pl.stride + 16)) {
    return cudaErrorInvalidValue;
  }
  return cudaSuccess;
}

template <class T>
int run(const void* cols, const void* blocks, const void* x, void* y, int64_t p, int64_t R,
        int64_t K, int64_t C, int64_t bm, int64_t semiring, void* stream, const Plan& pl,
        int64_t threads, int64_t smem) {
  cudaError_t err = check_plan<T>(pl, bm, threads, smem);
  if (err != cudaSuccess) return err;
  if (pl.bulk && (reinterpret_cast<uintptr_t>(blocks) % 16 || reinterpret_cast<uintptr_t>(x) % 16)) {
    return cudaErrorMisalignedAddress;
  }
  if (p == 0 || R == 0) return cudaSuccess;
  const int64_t tiles = p * R * ((bm + pl.rows - 1) / pl.rows);
  if (tiles > 0x7fffffff) return cudaErrorInvalidValue;
  const dim3 grid(static_cast<unsigned>(tiles));
  const dim3 block(static_cast<unsigned>(threads));
  const int bmi = static_cast<int>(bm);
  const auto s = static_cast<cudaStream_t>(stream);
  err = with_kernel<T>(semiring, vector_rows<T>(bm), [&](auto kernel) {
    kernel<<<grid, block, static_cast<size_t>(smem), s>>>(
        static_cast<const int32_t*>(cols), static_cast<const T*>(blocks),
        static_cast<const T*>(x), static_cast<T*>(y), R, K, C, bmi, pl);
    return cudaGetLastError();
  });
  return err;
}

template <class T>
cudaError_t occupancy(int64_t semiring, int64_t bm, int64_t threads, int64_t smem, int* ctas) {
  if (bm < 1 || threads % 32 != 0 || threads < 64 || threads > kMaxThreads || smem < 0) {
    return cudaErrorInvalidValue;
  }
  return with_kernel<T>(semiring, vector_rows<T>(bm), [&](auto kernel) {
    return cudaOccupancyMaxActiveBlocksPerMultiprocessor(ctas, kernel, static_cast<int>(threads),
                                                         static_cast<size_t>(smem));
  });
}

template <class T>
cudaError_t raise_limit(int bytes) {
  for (int64_t sr = 0; sr < 3; ++sr) {
    for (int vec = 0; vec < 2; ++vec) {
      const cudaError_t err = with_kernel<T>(sr, vec == 1, [&](auto kernel) {
        cudaError_t e =
            cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
        if (e != cudaSuccess) return e;
        return cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                                    static_cast<int>(cudaSharedmemCarveoutMaxShared));
      });
      if (err != cudaSuccess) return err;
    }
  }
  return cudaSuccess;
}

}  // namespace

extern "C" {

// cols (p,R,K) int32, blocks (p,R,K,bm,bm) T, x (p,C*bm) T -> y (p,R*bm) T,
// all contiguous on the current device; launched on `stream` with the tile
// plan of kernel.py::plan_tiles: rows, lanes, stages, bulk, the x slice's
// offset in a stage and the stage stride (bytes), `threads` a CTA and `smem`
// bytes of dynamic shared memory.  bulk needs bm*sizeof(T) a multiple of 16
// and blocks and x 16-byte aligned.  Each returns cudaGetLastError() after
// the launch (0 on success), or an error without launching for a plan the
// kernel does not take.  bsr_spmv_init must have run on the device.
#define BSR_SPMV_ENTRY(name, T)                                                                \
  int name(const void* cols, const void* blocks, const void* x, void* y, int64_t p, int64_t R, \
           int64_t K, int64_t C, int64_t bm, int64_t semiring, void* stream, int64_t rows,     \
           int64_t lanes, int64_t stages, int64_t bulk, int64_t x_off, int64_t stride,         \
           int64_t threads, int64_t smem) {                                                    \
    const Plan pl{static_cast<int>(rows),   static_cast<int>(lanes), static_cast<int>(stages), \
                  static_cast<int>(bulk),   static_cast<int>(x_off), static_cast<int>(stride)};\
    return run<T>(cols, blocks, x, y, p, R, K, C, bm, semiring, stream, pl, threads, smem);    \
  }

BSR_SPMV_ENTRY(bsr_spmv_f32, float)
BSR_SPMV_ENTRY(bsr_spmv_bf16, __nv_bfloat16)
BSR_SPMV_ENTRY(bsr_spmv_f16, __half)

// Raise every instance's dynamic shared-memory limit to what a block of the
// current device may opt into, and prefer shared memory over L1 in the
// carveout; that limit in *optin_bytes.  Once a device, before any launch
// and outside any capture.
int bsr_spmv_init(int* optin_bytes) {
  int bytes = 0;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  }
  if (err != cudaSuccess) return err;
  err = raise_limit<float>(bytes);
  if (err == cudaSuccess) err = raise_limit<__nv_bfloat16>(bytes);
  if (err == cudaSuccess) err = raise_limit<__half>(bytes);
  *optin_bytes = bytes;
  return err;
}

// The CTAs of a launch (dtype 0 float32, 1 bfloat16, 2 float16; the
// semiring's code; bm; `threads` a CTA and `smem` bytes of dynamic shared
// memory) that one SM of the current device holds at once
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor for the instance the
// launch picks), in *ctas.  Returns the CUDA error (0 on success).
int bsr_spmv_occupancy(int dtype, int64_t semiring, int64_t bm, int64_t threads, int64_t smem,
                       int* ctas) {
  switch (dtype) {
    case 0: return occupancy<float>(semiring, bm, threads, smem, ctas);
    case 1: return occupancy<__nv_bfloat16>(semiring, bm, threads, smem, ctas);
    case 2: return occupancy<__half>(semiring, bm, threads, smem, ctas);
    default: return cudaErrorInvalidValue;
  }
}

const char* bsr_spmv_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
