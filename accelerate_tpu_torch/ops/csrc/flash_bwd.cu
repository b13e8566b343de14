// Flash-attention backward for Hopper (sm_90a), written by hand: two kernels
// on mma.sync, each the route of its kernel where the wgmma one does not
// apply (flash_cuda._wgmma_route): flash_bwd_dkdv_kernel and
// flash_bwd_dq_kernel for float32 inputs and for head_dims other than 64,
// 80, 96, 128 and 256 (16-bit inputs there take flash_bwd_dkdv_sm90.cu and
// flash_bwd_dq_sm90.cu).
//
// Replaces the TPU kernels of accelerate_tpu/ops/flash_pallas.py launched by
// _flash_bwd:
//   flash_bwd_dkdv_kernel <- _bwd_dkdv_kernel: dV += P^T dO, dK += dS^T Q
//   flash_bwd_dq_kernel   <- _bwd_dq_kernel:   dQ += dS K
// with P = exp(s - lse) recomputed from the forward's logsumexp,
// dS = P * (dP - delta) * softcap_chain * sm_scale, dP = dO V^T and
// delta = rowsum(dO * O) (computed by the wrapper, as JAX computes it outside
// Pallas). The softcap chain factor 1 - (s_cap / cap)^2 takes the PRE-mask
// s_cap, and a masked pair gives P = 0 directly (no -1e30 is ever squared or
// exponentiated), so an empty row gives zeros, not NaN. P and dS are rounded
// to the input type before their products, as the TPU kernels do.
//
// Layout: q/dO/dQ [B, Sq, H, D], k/v/dK/dV [B, Sk, G, D] (the models' layout),
// lse/delta [B, H, Sq] f32 (lse once per row, as flash_fwd.cu stores it).
// Query head h reads kv head h / (H / G): GQA by index.
//
// What bounds them: at the training shape (B=8, S=1024, H=16, G=8, D=128,
// causal, bf16) dK/dV does 8 operations per visible (q, k) pair and head
// column (four products) and dQ 6 (three), ~69 and ~52 GFLOP, each over
// ~135 MB: the tensor-core rate bounds both, not the memory. The design
// keeps S, P, dP and dS in registers (they never reach shared or device
// memory) and runs every product on the tensor cores with mma.sync m16n8k16
// (bf16/fp16 in, f32 accumulate). Loads are plain 16-byte copies with no
// copy/compute overlap; wgmma, TMA and a pipeline are later work.
//
// Hopper blocks run in no order, so nothing carries from one block to the
// next and no block adds into another's output: no atomics, and two launches
// on the same inputs give bit-identical gradients.
//  - dK/dV: one block owns 64 keys of one (batch, kv head). It loops over the
//    rep query heads sharing that kv head and, for each, over the 32-query
//    tiles of the band (flash_pallas._q_band: causal from the diagonal, a
//    window up to k + w - 1), summing into f32 register accumulators, and
//    writes dK and dV once. The key tile 0 has the most causal work and
//    starts first.
//  - dQ: one block owns 64 queries of one (batch, head) and loops over the
//    32-key tiles of the band (flash_pallas._k_band), writing dQ once.
// Each warp owns 16 rows. head_dim 256 would need 256 f32 accumulators a
// thread for dK and dV; there the block has 8 warps, two per 16 rows, each
// recomputing the rows' S and dP and owning half of the output columns.
// fp32 inputs take a CUDA-core path of the same template with FMA products.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kOwn = 64;    // rows a block owns: 4 row groups of 16
constexpr int kInner = 32;  // rows of the other side per loop tile
constexpr unsigned kFull = 0xffffffffu;

struct Params {
  const void* q;
  const void* k;
  const void* v;
  const void* dout;
  const float* lse;    // [B, H, Sq]
  const float* delta;  // [B, H, Sq]
  const int* seg;      // [B, S] segment ids, or null
  void* dq;
  void* dk;
  void* dv;
  int H, G, Sq, Sk, D;
  float sm_scale;
  float softcap;  // <= 0: none
  int causal;
  int window;     // <= 0: none
};

template <typename T>
__device__ __forceinline__ uint32_t pack2(float lo, float hi);

template <>
__device__ __forceinline__ uint32_t pack2<__nv_bfloat16>(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

template <>
__device__ __forceinline__ uint32_t pack2<__half>(float lo, float hi) {
  __half2 v = __floats2half2_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

template <typename T>
__device__ __forceinline__ uint32_t ld32(const T* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// c[16x8] += a[16x16] * b[16x8], f32 accumulators.
template <typename T>
__device__ __forceinline__ void mma16816(float c[4], const uint32_t a[4], const uint32_t b[2]) {
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
  } else {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
  }
}

// Two transposed 8x8 b16 matrices from shared memory: lanes 0-7 give the row
// addresses of the first, lanes 8-15 of the second.
__device__ __forceinline__ void ldsm_x2_trans(uint32_t& r0, uint32_t& r1, const void* smem) {
  const uint32_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0,%1}, [%2];\n"
               : "=r"(r0), "=r"(r1)
               : "r"(addr));
}

template <typename T>
__device__ __forceinline__ void store2(T* dst, float x, float y) {
  if constexpr (std::is_same<T, float>::value) {
    *reinterpret_cast<float2*>(dst) = make_float2(x, y);
  } else {
    *reinterpret_cast<uint32_t*>(dst) = pack2<T>(x, y);
  }
}

// Shared row stride of a head_dim bucket DP: padded by 16 bytes, so the
// fragment loads of 8 consecutive rows hit 8 different bank groups.
template <typename T, int DP>
__host__ __device__ constexpr int row_stride() {
  return DP + 16 / static_cast<int>(sizeof(T));
}

// Copies rows [row0, row0 + ROWS) of one head (D elements each, `stride`
// elements apart in device memory) into shared memory. Rows past `nrows` and
// columns past D are zero.
template <typename T, int DP, int ROWS, int NTHREADS>
__device__ __forceinline__ void load_rows(T* dst, const T* src, size_t stride, int row0, int nrows,
                                          int D) {
  constexpr int kVec = 16 / sizeof(T);
  constexpr int kChunks = DP / kVec;
  constexpr int LD = row_stride<T, DP>();
  for (int c = threadIdx.x; c < ROWS * kChunks; c += NTHREADS) {
    const int r = c / kChunks;
    const int col = (c % kChunks) * kVec;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (row0 + r < nrows && col < D) {
      val = __ldg(reinterpret_cast<const uint4*>(src + (size_t)(row0 + r) * stride + col));
    }
    *reinterpret_cast<uint4*>(dst + r * LD + col) = val;
  }
}

// acc[j] += A B^T over the head dim, for the warp's 16 rows of A (shared,
// base `a`) against NT*8 rows of B (shared, base `b`).
//
// Accumulator layout (that of mma m16n8): lane = 4 * gid + tig owns rows gid
// and gid + 8 of the 16, and columns 2 * tig, 2 * tig + 1 of each 8-wide
// column tile: acc[j][0..1] for row gid, acc[j][2..3] for row gid + 8.
template <typename T, int DP, int NT>
__device__ __forceinline__ void rows_dot(float (&acc)[NT][4], const T* a, const T* b, int gid,
                                         int tig) {
  constexpr int LD = row_stride<T, DP>();
  if constexpr (std::is_same<T, float>::value) {
#pragma unroll 4
    for (int d = 0; d < DP; d += 2) {
      const float2 xa = *reinterpret_cast<const float2*>(a + gid * LD + d);
      const float2 xb = *reinterpret_cast<const float2*>(a + (gid + 8) * LD + d);
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const float2 ya = *reinterpret_cast<const float2*>(b + (8 * j + 2 * tig) * LD + d);
        const float2 yb = *reinterpret_cast<const float2*>(b + (8 * j + 2 * tig + 1) * LD + d);
        acc[j][0] += xa.x * ya.x + xa.y * ya.y;
        acc[j][1] += xa.x * yb.x + xa.y * yb.y;
        acc[j][2] += xb.x * ya.x + xb.y * ya.y;
        acc[j][3] += xb.x * yb.x + xb.y * yb.y;
      }
    }
  } else {
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk) {
      const T* pa = a + gid * LD + kk * 16 + 2 * tig;
      const uint32_t fa[4] = {ld32(pa), ld32(pa + 8 * LD), ld32(pa + 8), ld32(pa + 8 * LD + 8)};
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const T* pb = b + (8 * j + gid) * LD + kk * 16 + 2 * tig;
        const uint32_t fb[2] = {ld32(pb), ld32(pb + 8)};
        mma16816<T>(acc[j], fa, fb);
      }
    }
  }
}

// out += P B for the warp's 16 rows: P [16, NT*8] in accumulator layout (f32,
// rounded to T for the tensor cores), B [NT*8, D] row-major in shared memory,
// for the NO 8-wide output column tiles from column col0.
template <typename T, int DP, int NT, int NO>
__device__ __forceinline__ void acc_times_rows(float (&out)[NO][4], const float (&pm)[NT][4],
                                               const T* b, int col0, int lane) {
  constexpr int LD = row_stride<T, DP>();
  if constexpr (std::is_same<T, float>::value) {
    const int tig = lane & 3;
    // P row entries live on the quad's lanes; fetch each inner index's by shuffle.
#pragma unroll
    for (int jj = 0; jj < NT * 8; ++jj) {
      const int src = (lane & ~3) | ((jj & 7) >> 1);
      const float p0 = __shfl_sync(kFull, pm[jj >> 3][jj & 1], src);
      const float p1 = __shfl_sync(kFull, pm[jj >> 3][2 + (jj & 1)], src);
      const float* br = b + jj * LD + col0 + 2 * tig;
#pragma unroll
      for (int n = 0; n < NO; ++n) {
        const float2 bv = *reinterpret_cast<const float2*>(br + 8 * n);
        out[n][0] += p0 * bv.x;
        out[n][1] += p0 * bv.y;
        out[n][2] += p1 * bv.x;
        out[n][3] += p1 * bv.y;
      }
    }
  } else {
    // Two adjacent 8-column tiles in accumulator layout are exactly the A
    // operand of one m16n8k16 product.
#pragma unroll
    for (int kk = 0; kk < NT / 2; ++kk) {
      const uint32_t fa[4] = {pack2<T>(pm[2 * kk][0], pm[2 * kk][1]),
                              pack2<T>(pm[2 * kk][2], pm[2 * kk][3]),
                              pack2<T>(pm[2 * kk + 1][0], pm[2 * kk + 1][1]),
                              pack2<T>(pm[2 * kk + 1][2], pm[2 * kk + 1][3])};
      const T* brow = b + (kk * 16 + (lane & 15)) * LD + col0;
#pragma unroll
      for (int n = 0; n < NO; ++n) {
        uint32_t fb[2];
        ldsm_x2_trans(fb[0], fb[1], brow + 8 * n);
        mma16816<T>(out[n], fa, fb);
      }
    }
  }
}

// dS (and P) of one pair from the raw product s = q.k and dp = dO.v.
// Returns P; writes dS into dp. Masked pairs give P = dS = 0.
__device__ __forceinline__ float pair_grads(const Params& p, float s, float& dp, bool keep,
                                            float lse, float delta) {
  float x = s * p.sm_scale;
  float chain = 1.f;
  if (p.softcap > 0.f) {
    x = p.softcap * tanhf(x / p.softcap);  // pre-mask s_cap, |x| <= cap
    const float t = x / p.softcap;
    chain = 1.f - t * t;
  }
  const float prob = keep ? __expf(x - lse) : 0.f;
  dp = prob * (dp - delta) * chain * p.sm_scale;
  return prob;
}

__device__ __forceinline__ bool visible(const Params& p, int qpos, int kpos, int qseg, int kseg) {
  bool keep = qpos < p.Sq && kpos < p.Sk;
  if (p.causal) keep = keep && kpos <= qpos;
  if (p.window > 0) keep = keep && kpos > qpos - p.window;
  if (p.seg != nullptr) keep = keep && qseg == kseg;
  return keep;
}

template <int DP>
__host__ __device__ constexpr int splits() {
  return DP == 256 ? 2 : 1;
}

template <typename T, int DP>
__global__ void __launch_bounds__(128 * splits<DP>()) flash_bwd_dkdv_kernel(const Params p) {
  constexpr int NS = splits<DP>();
  constexpr int kThreads = 128 * NS;
  constexpr int LD = row_stride<T, DP>();
  constexpr int NT = kInner / 8;     // 8-query column tiles of S^T
  constexpr int NO = DP / NS / 8;    // 8-wide column tiles of dK / dV per warp

  extern __shared__ __align__(16) unsigned char smem[];
  T* k_s = reinterpret_cast<T*>(smem);
  T* v_s = k_s + kOwn * LD;
  T* q_s = v_s + kOwn * LD;
  T* do_s = q_s + kInner * LD;
  float* lse_s = reinterpret_cast<float*>(do_s + kInner * LD);
  float* delta_s = lse_s + kInner;
  int* qseg_s = reinterpret_cast<int*>(delta_s + kInner);

  const int k0 = blockIdx.x * kOwn;
  const int g = blockIdx.y;
  const int b = blockIdx.z;
  const int rep = p.H / p.G;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int gid = lane >> 2;
  const int tig = lane & 3;
  const int rg = warp & 3;                    // row group of 16 keys
  const int col0 = (warp >> 2) * (DP / NS);   // first output column of this warp

  const size_t q_stride = (size_t)p.H * p.D;
  const size_t kv_stride = (size_t)p.G * p.D;
  const size_t kv_off = (size_t)b * p.Sk * kv_stride + (size_t)g * p.D;
  load_rows<T, DP, kOwn, kThreads>(k_s, static_cast<const T*>(p.k) + kv_off, kv_stride, k0, p.Sk,
                                   p.D);
  load_rows<T, DP, kOwn, kThreads>(v_s, static_cast<const T*>(p.v) + kv_off, kv_stride, k0, p.Sk,
                                   p.D);

  const int key0 = k0 + rg * 16 + gid;
  const int key1 = key0 + 8;
  int kseg0 = 0, kseg1 = 0;
  if (p.seg != nullptr) {
    kseg0 = key0 < p.Sk ? p.seg[(size_t)b * p.Sk + key0] : 0;
    kseg1 = key1 < p.Sk ? p.seg[(size_t)b * p.Sk + key1] : 0;
  }

  // The band of query tiles (flash_pallas._q_band / _block_visible): causal
  // queries start at the block's first key; a window ends at its last key + w - 1.
  const int nq = (p.Sq + kInner - 1) / kInner;
  int qt_lo = 0, qt_hi = nq;
  if (p.causal) qt_lo = min(nq, k0 / kInner);
  if (p.window > 0) qt_hi = min(nq, (k0 + kOwn - 1 + p.window - 1) / kInner + 1);

  float dk[NO][4], dv[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n) {
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[n][e] = dv[n][e] = 0.f;
  }
  const T* kw = k_s + rg * 16 * LD;
  const T* vw = v_s + rg * 16 * LD;

  for (int r = 0; r < rep; ++r) {
    const int h = g * rep + r;
    const size_t q_off = (size_t)b * p.Sq * q_stride + (size_t)h * p.D;
    const T* qg = static_cast<const T*>(p.q) + q_off;
    const T* dog = static_cast<const T*>(p.dout) + q_off;
    const float* lse_g = p.lse + ((size_t)b * p.H + h) * p.Sq;
    const float* delta_g = p.delta + ((size_t)b * p.H + h) * p.Sq;
    for (int qt = qt_lo; qt < qt_hi; ++qt) {
      const int q0 = qt * kInner;
      __syncthreads();  // every warp is done with the previous tile
      load_rows<T, DP, kInner, kThreads>(q_s, qg, q_stride, q0, p.Sq, p.D);
      load_rows<T, DP, kInner, kThreads>(do_s, dog, q_stride, q0, p.Sq, p.D);
      if (threadIdx.x < kInner) {
        const int qr = q0 + threadIdx.x;
        const bool in = qr < p.Sq;
        lse_s[threadIdx.x] = in ? lse_g[qr] : 0.f;
        delta_s[threadIdx.x] = in ? delta_g[qr] : 0.f;
        qseg_s[threadIdx.x] = (in && p.seg != nullptr) ? p.seg[(size_t)b * p.Sq + qr] : 0;
      }
      __syncthreads();

      // S^T = K Q^T and dP^T = V dO^T: this warp's 16 keys x the tile's 32 queries.
      float s[NT][4], dp[NT][4];
#pragma unroll
      for (int j = 0; j < NT; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
      }
      rows_dot<T, DP, NT>(s, kw, q_s, gid, tig);
      rows_dot<T, DP, NT>(dp, vw, do_s, gid, tig);

#pragma unroll
      for (int j = 0; j < NT; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int c = 8 * j + 2 * tig + (e & 1);
          const bool keep = visible(p, q0 + c, e < 2 ? key0 : key1, qseg_s[c],
                                    e < 2 ? kseg0 : kseg1);
          s[j][e] = pair_grads(p, s[j][e], dp[j][e], keep, lse_s[c], delta_s[c]);
        }
      }

      acc_times_rows<T, DP, NT, NO>(dv, s, do_s, col0, lane);  // dV += P^T dO
      acc_times_rows<T, DP, NT, NO>(dk, dp, q_s, col0, lane);  // dK += dS^T Q
    }
  }

  T* dkg = static_cast<T*>(p.dk) + kv_off;
  T* dvg = static_cast<T*>(p.dv) + kv_off;
#pragma unroll
  for (int n = 0; n < NO; ++n) {
    const int col = col0 + 8 * n + 2 * tig;
    if (col < p.D) {
      if (key0 < p.Sk) {
        store2<T>(dkg + (size_t)key0 * kv_stride + col, dk[n][0], dk[n][1]);
        store2<T>(dvg + (size_t)key0 * kv_stride + col, dv[n][0], dv[n][1]);
      }
      if (key1 < p.Sk) {
        store2<T>(dkg + (size_t)key1 * kv_stride + col, dk[n][2], dk[n][3]);
        store2<T>(dvg + (size_t)key1 * kv_stride + col, dv[n][2], dv[n][3]);
      }
    }
  }
}

template <typename T, int DP>
__global__ void __launch_bounds__(128 * splits<DP>()) flash_bwd_dq_kernel(const Params p) {
  constexpr int NS = splits<DP>();
  constexpr int kThreads = 128 * NS;
  constexpr int LD = row_stride<T, DP>();
  constexpr int NT = kInner / 8;     // 8-key column tiles of S
  constexpr int NO = DP / NS / 8;    // 8-wide column tiles of dQ per warp

  extern __shared__ __align__(16) unsigned char smem[];
  T* q_s = reinterpret_cast<T*>(smem);
  T* do_s = q_s + kOwn * LD;
  T* k_s = do_s + kOwn * LD;
  T* v_s = k_s + kInner * LD;
  int* kseg_s = reinterpret_cast<int*>(v_s + kInner * LD);

  const int q0 = (gridDim.x - 1 - blockIdx.x) * kOwn;  // the longest causal rows start first
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / (p.H / p.G);
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int gid = lane >> 2;
  const int tig = lane & 3;
  const int rg = warp & 3;
  const int col0 = (warp >> 2) * (DP / NS);

  const size_t q_stride = (size_t)p.H * p.D;
  const size_t kv_stride = (size_t)p.G * p.D;
  const size_t q_off = (size_t)b * p.Sq * q_stride + (size_t)h * p.D;
  const size_t kv_off = (size_t)b * p.Sk * kv_stride + (size_t)kvh * p.D;
  load_rows<T, DP, kOwn, kThreads>(q_s, static_cast<const T*>(p.q) + q_off, q_stride, q0, p.Sq,
                                   p.D);
  load_rows<T, DP, kOwn, kThreads>(do_s, static_cast<const T*>(p.dout) + q_off, q_stride, q0,
                                   p.Sq, p.D);
  const T* kg = static_cast<const T*>(p.k) + kv_off;
  const T* vg = static_cast<const T*>(p.v) + kv_off;

  const int row0 = q0 + rg * 16 + gid;
  const int row1 = row0 + 8;
  const float* lse_g = p.lse + ((size_t)b * p.H + h) * p.Sq;
  const float* delta_g = p.delta + ((size_t)b * p.H + h) * p.Sq;
  const float lse0 = row0 < p.Sq ? lse_g[row0] : 0.f;
  const float lse1 = row1 < p.Sq ? lse_g[row1] : 0.f;
  const float delta0 = row0 < p.Sq ? delta_g[row0] : 0.f;
  const float delta1 = row1 < p.Sq ? delta_g[row1] : 0.f;
  int qseg0 = 0, qseg1 = 0;
  if (p.seg != nullptr) {
    qseg0 = row0 < p.Sq ? p.seg[(size_t)b * p.Sq + row0] : 0;
    qseg1 = row1 < p.Sq ? p.seg[(size_t)b * p.Sq + row1] : 0;
  }

  // The band of key tiles (flash_pallas._k_band / _block_visible).
  const int nk = (p.Sk + kInner - 1) / kInner;
  int kt_lo = 0, kt_hi = nk;
  if (p.causal) kt_hi = min(nk, (q0 + kOwn - 1) / kInner + 1);
  if (p.window > 0) kt_lo = max(0, q0 - p.window + 1) / kInner;

  float dq[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n) {
#pragma unroll
    for (int e = 0; e < 4; ++e) dq[n][e] = 0.f;
  }
  const T* qw = q_s + rg * 16 * LD;
  const T* dow = do_s + rg * 16 * LD;

  for (int kt = kt_lo; kt < kt_hi; ++kt) {
    const int k0 = kt * kInner;
    __syncthreads();
    load_rows<T, DP, kInner, kThreads>(k_s, kg, kv_stride, k0, p.Sk, p.D);
    load_rows<T, DP, kInner, kThreads>(v_s, vg, kv_stride, k0, p.Sk, p.D);
    if (p.seg != nullptr && threadIdx.x < kInner) {
      const int kr = k0 + threadIdx.x;
      kseg_s[threadIdx.x] = kr < p.Sk ? p.seg[(size_t)b * p.Sk + kr] : 0;
    }
    __syncthreads();

    // S = Q K^T and dP = dO V^T: this warp's 16 queries x the tile's 32 keys.
    float s[NT][4], dp[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
    }
    rows_dot<T, DP, NT>(s, qw, k_s, gid, tig);
    rows_dot<T, DP, NT>(dp, dow, v_s, gid, tig);

#pragma unroll
    for (int j = 0; j < NT; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = 8 * j + 2 * tig + (e & 1);
        const bool hi = e >= 2;
        const bool keep = visible(p, hi ? row1 : row0, k0 + c, hi ? qseg1 : qseg0,
                                  p.seg != nullptr ? kseg_s[c] : 0);
        pair_grads(p, s[j][e], dp[j][e], keep, hi ? lse1 : lse0, hi ? delta1 : delta0);
      }
    }

    acc_times_rows<T, DP, NT, NO>(dq, dp, k_s, col0, lane);  // dQ += dS K
  }

  T* dqg = static_cast<T*>(p.dq) + q_off;
#pragma unroll
  for (int n = 0; n < NO; ++n) {
    const int col = col0 + 8 * n + 2 * tig;
    if (col < p.D) {
      if (row0 < p.Sq) store2<T>(dqg + (size_t)row0 * q_stride + col, dq[n][0], dq[n][1]);
      if (row1 < p.Sq) store2<T>(dqg + (size_t)row1 * q_stride + col, dq[n][2], dq[n][3]);
    }
  }
}

template <typename T, int DP>
cudaError_t launch_dkdv(const Params& p, int B, cudaStream_t stream) {
  constexpr int LD = row_stride<T, DP>();
  const size_t smem = (size_t)(2 * kOwn + 2 * kInner) * LD * sizeof(T) +
                      kInner * (2 * sizeof(float) + sizeof(int));
  // Above 48 KB only as opted-in dynamic memory (fp32 at D=256 takes ~196 KB).
  cudaError_t err = cudaFuncSetAttribute(flash_bwd_dkdv_kernel<T, DP>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((p.Sk + kOwn - 1) / kOwn, p.G, B);
  flash_bwd_dkdv_kernel<T, DP><<<grid, 128 * splits<DP>(), smem, stream>>>(p);
  return cudaGetLastError();
}

template <typename T, int DP>
cudaError_t launch_dq(const Params& p, int B, cudaStream_t stream) {
  constexpr int LD = row_stride<T, DP>();
  const size_t smem = (size_t)(2 * kOwn + 2 * kInner) * LD * sizeof(T) + kInner * sizeof(int);
  cudaError_t err = cudaFuncSetAttribute(flash_bwd_dq_kernel<T, DP>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((p.Sq + kOwn - 1) / kOwn, p.H, B);
  flash_bwd_dq_kernel<T, DP><<<grid, 128 * splits<DP>(), smem, stream>>>(p);
  return cudaGetLastError();
}

template <typename T, bool DKDV>
cudaError_t launch_for_dim(const Params& p, int B, cudaStream_t stream) {
  if (p.D <= 64) return DKDV ? launch_dkdv<T, 64>(p, B, stream) : launch_dq<T, 64>(p, B, stream);
  if (p.D <= 128) {
    return DKDV ? launch_dkdv<T, 128>(p, B, stream) : launch_dq<T, 128>(p, B, stream);
  }
  return DKDV ? launch_dkdv<T, 256>(p, B, stream) : launch_dq<T, 256>(p, B, stream);
}

template <bool DKDV>
int launch_for_type(const Params& p, int dtype, int B, cudaStream_t stream) {
  switch (dtype) {
    case 0: return (int)launch_for_dim<float, DKDV>(p, B, stream);
    case 1: return (int)launch_for_dim<__nv_bfloat16, DKDV>(p, B, stream);
    case 2: return (int)launch_for_dim<__half, DKDV>(p, B, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16, 2 = float16. The caller has checked
// shapes, types, contiguity, 16-byte alignment, D % 16 == 0 and D <= 256.
// Each returns its launch's cudaError_t (0 on success).
extern "C" int flash_bwd_dkdv(const void* q, const void* k, const void* v, const void* dout,
                              const float* lse, const float* delta, const int* seg, void* dk,
                              void* dv, int dtype, int B, int H, int G, int Sq, int Sk, int D,
                              float sm_scale, float softcap, int causal, int window,
                              void* stream) {
  const Params p{q,  k,  v,  dout, lse, delta, seg,      nullptr, dk,     dv,
                 H,  G,  Sq, Sk,   D,   sm_scale, softcap, causal, window};
  return launch_for_type<true>(p, dtype, B, static_cast<cudaStream_t>(stream));
}

extern "C" int flash_bwd_dq(const void* q, const void* k, const void* v, const void* dout,
                            const float* lse, const float* delta, const int* seg, void* dq,
                            int dtype, int B, int H, int G, int Sq, int Sk, int D, float sm_scale,
                            float softcap, int causal, int window, void* stream) {
  const Params p{q,  k,  v,  dout, lse, delta, seg,      dq,      nullptr, nullptr,
                 H,  G,  Sq, Sk,   D,   sm_scale, softcap, causal, window};
  return launch_for_type<false>(p, dtype, B, static_cast<cudaStream_t>(stream));
}

extern "C" const char* flash_bwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
