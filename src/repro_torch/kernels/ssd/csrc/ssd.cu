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
// with h (ds, dh) in float32, zero at the first chunk.  Layout: x/y
// (B, T, nh, dh), b/c (B, T, G, ds), a (B, T, nh) float32, the final state
// (B, nh, ds, dh) float32 (optional).  Head h reads the b/c of group
// h / (nh / G) in place: the reference's jnp.repeat is never materialised.
//
// What bounds it on this card: ~2·(dh + ds) bytes a step against
// ~4·ds·dh + L·(ds + dh) multiply-adds a step, so the products, and on the
// CUDA cores (67 TFLOP/s float32) they take 7x longer than the bytes.  On
// the bf16 tensor cores (989 TFLOP/s), even with the float32 operands in two
// passes, the bytes bound it (0.067 ms at mamba2-780m's prefill shape).
//
// The bfloat16 instance (ssd_scan_tc, the model's path):
//
// * One CTA of 4 warps per (b, h) walks the sequence in sub-chunks of
//   kL = 32 steps with h on chip: no state traffic through device memory,
//   no cross-CTA carry (the TPU kernel carries h in scratch across a
//   sequential chunk axis).  The chunked form computes the same recurrence
//   for any chunk length, so the caller's `chunk` changes only where the
//   reference rounds; the kernel's own 32 keeps the causal triangle small
//   (3 of 4 16x16 tiles) and the shared memory at 72 KB, so 3 CTAs fit an
//   SM and mamba2-780m's 384 (b, h) run in one wave over 132 SMs.
// * Every product runs as mma.sync.m16n8k16 bf16 with float32 accumulation
//   (fragments by ldmatrix from XOR-swizzled tiles):
//   - C·Bᵀ: both operands bf16, exact;
//   - (C·Bᵀ ⊙ M)·X, C·h and Bᵀ·(w ⊙ X): the float32 operand
//     (the masked, decayed scores, h, and w_s x_s) is split into a bf16
//     high and a bf16 low part and the product runs twice; the other operand
//     is exact in bf16.  The split keeps each value to ~2^-17, 26x inside
//     the float32 tolerance of the state (2e-4).
//   The scores never leave registers: the accumulator of C·Bᵀ is the A
//   operand of the next product, split in place.  h is a float32
//   accumulator in registers (each warp owns a band of its rows), and each
//   sub-chunk it is written to shared memory as its hi/lo pair for the next
//   sub-chunk's C·h.
// * Loads: the next sub-chunk's x, b, c (16-byte cp.async) and a (4-byte)
//   go into a second buffer while this one computes; steps past T are
//   zero-filled by the copy (a = 0 leaves h unchanged) and their y is not
//   written.
// * The cumsum of a is a warp scan (one step a lane); every warp keeps
//   cum in registers and reads what it needs by shuffles.
// * The decay exponent is masked before the exp: exp(cum_t - cum_s) for
//   s > t can overflow, and inf * 0 is NaN.
// * C·Bᵀ is computed again by every head of a group (mamba2-780m: 48 heads,
//   one group) and by both warps of a row band: 96 of the 656 mma.sync a
//   CTA issues a sub-chunk; sharing it would need the heads of a group in
//   one CTA and their states on chip.
// * Takes dh <= 64 and ds <= 128, both multiples of 8, padded on chip to
//   (32 or 64) and (32, 64 or 128) with zeros.
//
// The float32 instance (ssd_scan_f32, the float32 replay and tests) stays
// on the CUDA cores, off the serving path: with float32 x, b and c a
// two-term split's 2^-17, amplified over 48 layers as the bf16 run's
// rounding is, would by estimate come near the float32 decode-vs-forward
// limit of 1e-4, and a three-term split needs six products for each.  One
// CTA per (b, h) walks the caller's chunks with h in shared memory; the
// scores are processed kRows rows at a time, register tiles of up to 4x4.
//
// Build without --use_fast_math (expf, not __expf).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;
constexpr unsigned kFull = 0xffffffffu;

// ---------------------------------------------------------------------------
// bfloat16 instance on the tensor cores
// ---------------------------------------------------------------------------

constexpr int kL = 32;             // steps a sub-chunk
constexpr int kWarps = 4;
constexpr int kTcThreads = 32 * kWarps;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// element offset of (r, col) in a row-major tile of N bf16 a row whose
// 16-byte chunks are XOR-swizzled, so that the 8 rows an ldmatrix reads at
// one column fall in 8 different bank groups
template <int N>
__device__ __forceinline__ int swz(int r, int col) {
  constexpr int chunks = N / 8;
  static_assert(chunks == 4 || chunks == 8 || chunks == 16, "row of 32, 64 or 128");
  const int c = (col >> 3) ^ (chunks >= 8 ? (r & 7) : ((r >> 1) & 3));
  return r * N + (c << 3) + (col & 7);
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(smem_addr(p)));
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(smem_addr(p)));
}

// d += a (16x16, row) * b (16x8, col), bf16 in, float32 accumulate
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                    uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t as_u32(__nv_bfloat162 v) {
  return *reinterpret_cast<uint32_t*>(&v);
}

// (x0, x1) as a packed bf16 pair hi and the pair of what hi misses, lo
__device__ __forceinline__ void split(float x0, float x1, uint32_t& hi, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  const float2 hf = __bfloat1622float2(h);
  hi = as_u32(h);
  lo = as_u32(__floats2bfloat162_rn(x0 - hf.x, x1 - hf.y));
}

__device__ __forceinline__ float2 unpack(uint32_t v) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v));
}

__device__ __forceinline__ void cp_async16_zfill(void* smem, const void* gmem, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_addr(smem)), "l"(gmem), "r"(valid ? 16 : 0));
}
__device__ __forceinline__ void cp_async4_zfill(void* smem, const void* gmem, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(smem_addr(smem)), "l"(gmem), "r"(valid ? 4 : 0));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n"); }
__device__ __forceinline__ void cp_async_wait_all() { asm volatile("cp.async.wait_group 0;\n"); }

template <int DSP, int DHP>
__host__ __device__ constexpr int tc_buffer_bytes() { return kL * DHP * 2 + 2 * kL * DSP * 2 + kL * 4; }
template <int DSP, int DHP>
__host__ __device__ constexpr int tc_smem_bytes() { return 2 * tc_buffer_bytes<DSP, DHP>() + 2 * DSP * DHP * 2; }

// grid (nh, B), block kTcThreads.  DSP, DHP: ds and dh padded on chip.
template <int DSP, int DHP>
__global__ void __launch_bounds__(kTcThreads, 3)
ssd_scan_tc(const bf16* __restrict__ x, const bf16* __restrict__ b, const bf16* __restrict__ c,
            const float* __restrict__ a, bf16* __restrict__ y, float* __restrict__ h_last,
            int64_t T_len, int nh, int groups, int dh, int ds) {
  constexpr int kNT = DHP / 8;                    // n8 tiles across dh
  constexpr int kMT = DSP / 16;                   // m16 tiles across ds
  constexpr int kNY = kNT / 2;                    // Y phase: n8 tiles a warp
  constexpr int kMW = kMT >= kWarps ? kMT / kWarps : 1;      // state: m16 tiles a warp
  constexpr int kNW = kMT >= kWarps ? kNT : kNT * kMT / kWarps;  // state: n8 tiles a warp
  static_assert(kNY % 2 == 0 && kNW % 2 == 0, "n8 tiles go in pairs");
  extern __shared__ __align__(128) unsigned char smem_raw[];
  // buffer i: x (kL x DHP), b and c (kL x DSP) in bf16, a (kL) in float32
  auto xs = [&](int i) {
    return reinterpret_cast<bf16*>(smem_raw + i * tc_buffer_bytes<DSP, DHP>());
  };
  auto bs = [&](int i) { return xs(i) + kL * DHP; };
  auto cs = [&](int i) { return bs(i) + kL * DSP; };
  auto as = [&](int i) { return reinterpret_cast<float*>(cs(i) + kL * DSP); };
  bf16* hhi = reinterpret_cast<bf16*>(smem_raw + 2 * tc_buffer_bytes<DSP, DHP>());  // DSP x DHP
  bf16* hlo = hhi + DSP * DHP;

  const int h = blockIdx.x;
  const int64_t bb = blockIdx.y;
  const int g = h / (nh / groups);
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int gq = lane >> 2;                       // fragment row
  const int tq = lane & 3;                        // fragment column pair

  // zero once: the padding columns stay zero, and h starts at zero
  for (int i = tid; i < tc_smem_bytes<DSP, DHP>() / 16; i += kTcThreads) {
    reinterpret_cast<uint4*>(smem_raw)[i] = make_uint4(0, 0, 0, 0);
  }
  __syncthreads();

  const int xchunks = dh / 8;
  const int bchunks = ds / 8;
  auto load = [&](int64_t sub, int buf) {
    const int64_t t0 = sub * kL;
    for (int i = tid; i < kL * xchunks; i += kTcThreads) {
      const int r = i / xchunks;
      const int ch = i - r * xchunks;
      const int64_t t = t0 + r;
      const bool valid = t < T_len;
      const bf16* src = x + (((valid ? bb * T_len + t : 0) * nh + h) * dh + ch * 8);
      cp_async16_zfill(xs(buf) + swz<DHP>(r, ch * 8), src, valid);
    }
    for (int i = tid; i < kL * bchunks; i += kTcThreads) {
      const int r = i / bchunks;
      const int ch = i - r * bchunks;
      const int64_t t = t0 + r;
      const bool valid = t < T_len;
      const int64_t off = ((valid ? bb * T_len + t : 0) * groups + g) * ds + ch * 8;
      cp_async16_zfill(bs(buf) + swz<DSP>(r, ch * 8), b + off, valid);
      cp_async16_zfill(cs(buf) + swz<DSP>(r, ch * 8), c + off, valid);
    }
    if (tid < kL) {
      const int64_t t = t0 + tid;
      const bool valid = t < T_len;
      cp_async4_zfill(as(buf) + tid, a + (valid ? bb * T_len + t : 0) * nh + h, valid);
    }
  };

  // the state: warp w owns m16 tiles {w, w+4, ..} (or one tile and a band
  // of its columns where ds has fewer than 4 tiles), as float32 accumulators
  const int st_m0 = kMT >= kWarps ? warp : warp % kMT;
  const int st_n0 = kMT >= kWarps ? 0 : (warp / kMT) * kNW;
  float hacc[kMW][kNW][4];
#pragma unroll
  for (int i = 0; i < kMW; ++i)
#pragma unroll
    for (int j = 0; j < kNW; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) hacc[i][j][e] = 0.0f;

  // Y phase: warp w computes rows [16 r, 16 r + 16) of the sub-chunk and a
  // half of dh's n8 tiles
  const int yr = warp >> 1;
  const int yn0 = (warp & 1) * kNY;

  const int64_t nsub = (T_len + kL - 1) / kL;
  load(0, 0);
  cp_async_commit();
  for (int64_t sub = 0; sub < nsub; ++sub) {
    const int buf = static_cast<int>(sub & 1);
    cp_async_wait_all();
    __syncthreads();       // this sub-chunk landed; the last one's h is written
    if (sub + 1 < nsub) load(sub + 1, buf ^ 1);
    cp_async_commit();
    const bf16* xb = xs(buf);
    const bf16* bsb = bs(buf);
    const bf16* csb = cs(buf);

    // cum (inclusive scan of a over the sub-chunk), one step a lane
    float cum = as(buf)[lane];
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const float v = __shfl_up_sync(kFull, cum, off);
      if (lane >= off) cum += v;
    }
    const float cum_last = __shfl_sync(kFull, cum, kL - 1);
    const int t_lo = 16 * yr + gq;          // this thread's two Y rows
    const float cum_tlo = __shfl_sync(kFull, cum, t_lo);
    const float cum_thi = __shfl_sync(kFull, cum, t_lo + 8);
    float cum_s[2][4];                      // columns of the two score tiles
#pragma unroll
    for (int cc = 0; cc < 2; ++cc)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        cum_s[cc][e] = __shfl_sync(kFull, cum, 16 * cc + 2 * tq + (e & 1) + 8 * (e >> 1));

    // ---- Y phase: C h (inter) and C Bᵀ (scores) over ds --------------------
    float yacc[kNY][4];
    float sacc[2][2][4];
#pragma unroll
    for (int j = 0; j < kNY; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) yacc[j][e] = 0.0f;
#pragma unroll
    for (int cc = 0; cc < 2; ++cc)
#pragma unroll
      for (int nn = 0; nn < 2; ++nn)
#pragma unroll
        for (int e = 0; e < 4; ++e) sacc[cc][nn][e] = 0.0f;
#pragma unroll
    for (int kk = 0; kk < DSP; kk += 16) {
      uint32_t af[4];
      ldsm_x4(af, csb + swz<DSP>(16 * yr + (lane & 15), kk + (lane >> 4) * 8));
#pragma unroll
      for (int j = 0; j < kNY; j += 2) {
        const int hr = kk + (lane & 7) + ((lane >> 3) & 1) * 8;
        const int hc = (yn0 + j) * 8 + (lane >> 4) * 8;
        uint32_t bh[4], bl[4];
        ldsm_x4_t(bh, hhi + swz<DHP>(hr, hc));
        ldsm_x4_t(bl, hlo + swz<DHP>(hr, hc));
        mma(yacc[j], af, bh[0], bh[1]);
        mma(yacc[j], af, bl[0], bl[1]);
        mma(yacc[j + 1], af, bh[2], bh[3]);
        mma(yacc[j + 1], af, bl[2], bl[3]);
      }
#pragma unroll
      for (int cc = 0; cc < 2; ++cc) {
        if (cc <= yr) {                     // warp-uniform
          uint32_t bf[4];
          ldsm_x4(bf, bsb + swz<DSP>(16 * cc + (lane & 7) + ((lane >> 4) << 3),
                                     kk + ((lane >> 3) & 1) * 8));
          mma(sacc[cc][0], af, bf[0], bf[1]);
          mma(sacc[cc][1], af, bf[2], bf[3]);
        }
      }
    }
    // inter: exp(cum_t) (C h)
    const float e_lo = expf(cum_tlo), e_hi = expf(cum_thi);
#pragma unroll
    for (int j = 0; j < kNY; ++j) {
      yacc[j][0] *= e_lo; yacc[j][1] *= e_lo;
      yacc[j][2] *= e_hi; yacc[j][3] *= e_hi;
    }
    // intra: the masked, decayed scores (split hi/lo in registers) times X
#pragma unroll
    for (int cc = 0; cc < 2; ++cc) {
      if (cc <= yr) {
        float p[2][4];
#pragma unroll
        for (int nn = 0; nn < 2; ++nn)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int t = t_lo + 8 * (e >> 1);
            const int s = 16 * cc + 8 * nn + 2 * tq + (e & 1);
            const float ct = e < 2 ? cum_tlo : cum_thi;
            const float cs_ = cum_s[cc][(e & 1) + 2 * nn];
            const float dec = expf(s <= t ? ct - cs_ : 0.0f);   // masked before the exp
            p[nn][e] = s <= t ? sacc[cc][nn][e] * dec : 0.0f;
          }
        uint32_t phi[4], plo[4];
        split(p[0][0], p[0][1], phi[0], plo[0]);
        split(p[0][2], p[0][3], phi[1], plo[1]);
        split(p[1][0], p[1][1], phi[2], plo[2]);
        split(p[1][2], p[1][3], phi[3], plo[3]);
#pragma unroll
        for (int j = 0; j < kNY; j += 2) {
          uint32_t bx[4];
          ldsm_x4_t(bx, xb + swz<DHP>(16 * cc + (lane & 7) + ((lane >> 3) & 1) * 8,
                                      (yn0 + j) * 8 + (lane >> 4) * 8));
          mma(yacc[j], phi, bx[0], bx[1]);
          mma(yacc[j], plo, bx[0], bx[1]);
          mma(yacc[j + 1], phi, bx[2], bx[3]);
          mma(yacc[j + 1], plo, bx[2], bx[3]);
        }
      }
    }
    {
      const int64_t t0 = sub * kL;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int64_t t = t0 + t_lo + 8 * half;
        if (t < T_len) {
          bf16* yrow = y + ((bb * T_len + t) * nh + h) * dh;
#pragma unroll
          for (int j = 0; j < kNY; ++j) {
            const int col = (yn0 + j) * 8 + 2 * tq;
            if (col < dh) {
              *reinterpret_cast<__nv_bfloat162*>(yrow + col) =
                  __floats2bfloat162_rn(yacc[j][2 * half], yacc[j][2 * half + 1]);
            }
          }
        }
      }
    }
    __syncthreads();       // every warp has read h for C h

    // ---- state phase: h = exp(cum_L) h + Bᵀ (w ⊙ X), w_s = exp(cum_L - cum_s)
    const float d_last = expf(cum_last);
#pragma unroll
    for (int i = 0; i < kMW; ++i)
#pragma unroll
      for (int j = 0; j < kNW; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) hacc[i][j][e] *= d_last;
    const float w_lane = expf(cum_last - cum);
#pragma unroll
    for (int ks = 0; ks < kL; ks += 16) {
      const float w0 = __shfl_sync(kFull, w_lane, ks + 2 * tq);
      const float w1 = __shfl_sync(kFull, w_lane, ks + 2 * tq + 1);
      const float w2 = __shfl_sync(kFull, w_lane, ks + 2 * tq + 8);
      const float w3 = __shfl_sync(kFull, w_lane, ks + 2 * tq + 9);
      uint32_t whi[kNW][2], wlo[kNW][2];
#pragma unroll
      for (int j = 0; j < kNW; j += 2) {
        uint32_t bx[4];
        ldsm_x4_t(bx, xb + swz<DHP>(ks + (lane & 7) + ((lane >> 3) & 1) * 8,
                                    (st_n0 + j) * 8 + (lane >> 4) * 8));
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const float2 v = unpack(bx[q]);
          const bool upper_k = q & 1;     // b1: steps ks + 8 + 2 tq (+1)
          split(v.x * (upper_k ? w2 : w0), v.y * (upper_k ? w3 : w1),
                whi[j + (q >> 1)][q & 1], wlo[j + (q >> 1)][q & 1]);
        }
      }
#pragma unroll
      for (int i = 0; i < kMW; ++i) {
        const int m0 = (st_m0 + i * kWarps) * 16;
        uint32_t af[4];
        ldsm_x4_t(af, bsb + swz<DSP>(ks + (lane & 7) + (lane >> 4) * 8,
                                     m0 + ((lane >> 3) & 1) * 8));
#pragma unroll
        for (int j = 0; j < kNW; ++j) {
          mma(hacc[i][j], af, whi[j][0], whi[j][1]);
          mma(hacc[i][j], af, wlo[j][0], wlo[j][1]);
        }
      }
    }
    // h as its hi/lo pair for the next sub-chunk's C h
#pragma unroll
    for (int i = 0; i < kMW; ++i)
#pragma unroll
      for (int j = 0; j < kNW; ++j)
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int r = (st_m0 + i * kWarps) * 16 + gq + 8 * half;
          const int col = (st_n0 + j) * 8 + 2 * tq;
          uint32_t hi, lo;
          split(hacc[i][j][2 * half], hacc[i][j][2 * half + 1], hi, lo);
          *reinterpret_cast<uint32_t*>(hhi + swz<DHP>(r, col)) = hi;
          *reinterpret_cast<uint32_t*>(hlo + swz<DHP>(r, col)) = lo;
        }
  }
  if (h_last != nullptr) {
    float* out = h_last + (bb * nh + h) * static_cast<int64_t>(ds) * dh;
#pragma unroll
    for (int i = 0; i < kMW; ++i)
#pragma unroll
      for (int j = 0; j < kNW; ++j)
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int r = (st_m0 + i * kWarps) * 16 + gq + 8 * half;
          const int col = (st_n0 + j) * 8 + 2 * tq;
          if (r < ds && col < dh) {
            *reinterpret_cast<float2*>(out + static_cast<int64_t>(r) * dh + col) =
                make_float2(hacc[i][j][2 * half], hacc[i][j][2 * half + 1]);
          }
        }
  }
}

// With `ctas` null launch_tc, dispatch_tc and launch_f32 launch; otherwise
// they launch nothing and set *ctas to the CTAs of that launch an SM holds
// at once.
template <int DSP, int DHP>
cudaError_t launch_tc(const void* x, const void* b, const void* c, const float* a, void* y,
                      float* h_last, int64_t B, int64_t T_len, int64_t nh, int64_t groups,
                      int64_t dh, int64_t ds, cudaStream_t stream, int* ctas) {
  constexpr int smem = tc_smem_bytes<DSP, DHP>();
  auto kernel = ssd_scan_tc<DSP, DHP>;
  if (smem > 48 * 1024) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
  }
  if (ctas != nullptr) {
    return cudaOccupancyMaxActiveBlocksPerMultiprocessor(ctas, kernel, kTcThreads, smem);
  }
  const dim3 grid(static_cast<unsigned>(nh), static_cast<unsigned>(B));
  kernel<<<grid, kTcThreads, smem, stream>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(b), static_cast<const bf16*>(c), a,
      static_cast<bf16*>(y), h_last, T_len, static_cast<int>(nh), static_cast<int>(groups),
      static_cast<int>(dh), static_cast<int>(ds));
  return cudaGetLastError();
}

template <int DHP>
cudaError_t dispatch_tc(const void* x, const void* b, const void* c, const float* a, void* y,
                        float* h_last, int64_t B, int64_t T_len, int64_t nh, int64_t groups,
                        int64_t dh, int64_t ds, cudaStream_t s, int* ctas) {
  if (ds <= 32) return launch_tc<32, DHP>(x, b, c, a, y, h_last, B, T_len, nh, groups, dh, ds, s, ctas);
  if (ds <= 64) return launch_tc<64, DHP>(x, b, c, a, y, h_last, B, T_len, nh, groups, dh, ds, s, ctas);
  return launch_tc<128, DHP>(x, b, c, a, y, h_last, B, T_len, nh, groups, dh, ds, s, ctas);
}

// ---------------------------------------------------------------------------
// float32 instance on the CUDA cores
// ---------------------------------------------------------------------------

constexpr int kF32Threads = 512;
constexpr int kRows = 32;          // score rows per pass
constexpr int kT = kRows + 4;      // row stride of the transposed c and scores

// grid (nh, B), block kF32Threads.  L is the chunk, Lp = L rounded up to kRows.
__global__ void __launch_bounds__(kF32Threads)
ssd_scan_f32(const float* __restrict__ x, const float* __restrict__ b, const float* __restrict__ c,
             const float* __restrict__ a, float* __restrict__ y, float* __restrict__ h_last,
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

  for (int i = tid; i < ds * dh; i += kF32Threads) hs[i] = 0.0f;
  const int64_t nchunks = (T_len + L - 1) / L;
  for (int64_t ch = 0; ch < nchunks; ++ch) {
    const int64_t t0 = ch * L;
    __syncthreads();  // the previous chunk's state update is complete
    for (int i = tid; i < Lp * dh; i += kF32Threads) {
      const int r = i / dh;
      const int e = i - r * dh;
      const int64_t t = t0 + r;
      xs[i] = r < L && t < T_len ? (x[((bb * T_len + t) * nh + h) * dh + e]) : 0.0f;
    }
    for (int i = tid; i < Lp * ds; i += kF32Threads) {
      const int r = i / ds;
      const int k = i - r * ds;
      const int64_t t = t0 + r;
      bs[r * bstride + k] =
          r < L && t < T_len ? (b[((bb * T_len + t) * groups + g) * ds + k]) : 0.0f;
    }
    for (int i = tid; i < Lp; i += kF32Threads) {
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
    for (int i = tid; i < Lp; i += kF32Threads) wdec[i] = expf(cum_last - cum[i]);

    for (int r0 = 0; r0 < Lp; r0 += kRows) {
      __syncthreads();  // the previous pass is done with cT and sT
      for (int i = tid; i < kRows * ds; i += kF32Threads) {
        const int rr = i / ds;
        const int k = i - rr * ds;
        const int r = r0 + rr;
        const int64_t t = t0 + r;
        cT[k * kT + rr] =
            r < L && t < T_len ? (c[((bb * T_len + t) * groups + g) * ds + k]) : 0.0f;
      }
      __syncthreads();
      // masked scores, tiles of 4 rows x 2 columns:
      // sT[s][t] = (c_t . b_s) exp(cum_t - cum_s) for s <= t, else 0
      for (int item = tid; item < 4 * Lp; item += kF32Threads) {
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
      for (int item = tid; item < kRows * ndg; item += kF32Threads) {
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
          float* yr = y + ((bb * T_len + tg) * nh + h) * dh + d0;
#pragma unroll
          for (int j = 0; j < 4; ++j) yr[j] = yi[j] + dec * yc[j];
        }
      }
    }
    __syncthreads();  // every row has read h_in
    // state update, tiles of 4 x 4: h = exp(cum_L) h + sum_s w_s b_s x_s^T
    const float d_last = expf(cum_last);
    for (int item = tid; item < (ds / 4) * ndg; item += kF32Threads) {
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
    for (int i = tid; i < ds * dh; i += kF32Threads) out[i] = hs[i];
  }
}

cudaError_t launch_f32(const void* x, const void* b, const void* c, const float* a, void* y,
                       float* h_last, int64_t B, int64_t T_len, int64_t nh, int64_t groups,
                       int64_t dh, int64_t ds, int64_t L, cudaStream_t stream, int* ctas) {
  const int64_t Lp = (L + kRows - 1) / kRows * kRows;
  const size_t smem = sizeof(float) * static_cast<size_t>(
      ds * dh + Lp * (ds + 1) + Lp * dh + ds * kT + Lp * kT + 2 * Lp);
  auto kernel = ssd_scan_f32;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  if (ctas != nullptr) {
    return cudaOccupancyMaxActiveBlocksPerMultiprocessor(ctas, kernel, kF32Threads, smem);
  }
  const dim3 grid(static_cast<unsigned>(nh), static_cast<unsigned>(B));
  kernel<<<grid, kF32Threads, smem, stream>>>(
      static_cast<const float*>(x), static_cast<const float*>(b), static_cast<const float*>(c), a,
      static_cast<float*>(y), h_last, T_len, static_cast<int>(nh), static_cast<int>(groups),
      static_cast<int>(dh), static_cast<int>(ds), static_cast<int>(L), static_cast<int>(Lp));
  return cudaGetLastError();
}
cudaError_t scan(int dtype, const void* x, const void* b, const void* c, const void* a,
                 void* y, void* h_last, int64_t B, int64_t T_len, int64_t nh, int64_t groups,
                 int64_t dh, int64_t ds, int64_t L, void* stream, int* ctas) {
  if (T_len <= 0 || L <= 0 || groups <= 0 || nh % groups || dh % 4 || ds % 4) {
    return cudaErrorInvalidValue;
  }
  const auto* av = static_cast<const float*>(a);
  auto* hv = static_cast<float*>(h_last);
  const auto s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return launch_f32(x, b, c, av, y, hv, B, T_len, nh, groups, dh, ds, L, s, ctas);
    case 1:
      if (dh % 8 || ds % 8 || dh > 64 || ds > 128) return cudaErrorInvalidValue;
      if (dh <= 32) return dispatch_tc<32>(x, b, c, av, y, hv, B, T_len, nh, groups, dh, ds, s, ctas);
      return dispatch_tc<64>(x, b, c, av, y, hv, B, T_len, nh, groups, dh, ds, s, ctas);
    default: return cudaErrorInvalidValue;
  }
}
}  // namespace

extern "C" {

// dtype 0: float32, 1: bfloat16 (x, b, c, y alike; a float32).  x/y
// (B, T, nh, dh), b/c (B, T, G, ds), a (B, T, nh), h_last (B, nh, ds, dh)
// float32 or null; all contiguous on the current device, x, b and c 16-byte
// aligned for bfloat16; launched on `stream`.  L is the chunk length
// (<= T) of the float32 instance; the bfloat16 instance walks sub-chunks
// of 32 whatever L is.  Returns cudaErrorInvalidValue for nh % G != 0, for
// dh or ds not multiples of 4 (float32), or not multiples of 8, dh > 64 or
// ds > 128 (bfloat16); the error of the launch for B > 65535 or a float32
// working set above a CTA's shared memory; else cudaGetLastError() after
// the launch (0 on success).
int ssd_scan(int dtype, const void* x, const void* b, const void* c, const void* a, void* y,
             void* h_last, int64_t B, int64_t T_len, int64_t nh, int64_t groups, int64_t dh,
             int64_t ds, int64_t L, void* stream) {
  if (B == 0 || nh == 0) return cudaSuccess;
  return scan(dtype, x, b, c, a, y, h_last, B, T_len, nh, groups, dh, ds, L, stream, nullptr);
}

// The CTAs of ssd_scan's launch for (dtype, dh, ds, L) that one SM of the
// current device holds at once (cudaOccupancyMaxActiveBlocksPerMultiprocessor
// for the kernel, block and shared memory that launch uses), in *ctas.
// Returns the CUDA error (0 on success).
int ssd_occupancy(int dtype, int64_t dh, int64_t ds, int64_t L, int* ctas) {
  return scan(dtype, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, 1, L, 1, 1, dh, ds,
              L, nullptr, ctas);
}

const char* ssd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
