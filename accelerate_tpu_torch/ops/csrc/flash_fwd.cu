// Flash-attention forward for Hopper (sm_90a), written by hand, on mma.sync:
// the route of float32 inputs and of head_dims other than 64, 80, 96, 128
// and 256 (flash_cuda._wgmma_route("forward", ...) is False). 16-bit inputs
// at those head_dims take flash_fwd_sm90.cu.
//
// Replaces the TPU kernel accelerate_tpu/ops/flash_pallas.py::_fwd_kernel
// (launched by _flash_fwd): tiled online-softmax attention with a running
// max m, sum l and f32 accumulator per query row, O = acc / l (l == 0 -> 1)
// and the logsumexp residual lse = m + log l for the backward pass.
//
// Layout: q [B, Sq, H, D], k/v [B, Sk, G, D] (the models' layout, no
// transpose), out [B, Sq, H, D] in q's type, lse [B, H, Sq] f32. Query head h
// reads kv head h / (H / G): GQA by index, never by a repeated K/V copy.
//
// What bounds it: at the main-path shape (Llama-3-8B widths, B=4, S=2048,
// H=32, G=8, D=128, causal, bf16) a call does ~137 GFLOP of products over
// ~169 MB of inputs and outputs, ~800 operations per byte, so the card's
// tensor-core rate bounds it, not its memory. The design keeps the S and P
// tiles in registers (they never reach device memory), feeds both products
// to the tensor cores with mma.sync m16n8k16 (bf16/fp16 in, f32 accumulate),
// and visits only the key tiles of the causal/window band, so the work is
// what the mask leaves: O(S * w) with a window. Loads are plain 16-byte
// vector copies into shared memory with no copy/compute overlap; wgmma, TMA
// and warp specialisation are what would lift it towards the bound.
//
// One block of 4 warps owns 64 query rows of one (batch, head); each warp
// owns 16 rows. The loop over 64-key tiles takes the place of the TPU's
// sequential grid axis. fp32 inputs take a CUDA-core path of the same
// template: the same tiles, mask and softmax, with the two products done by
// FMA in the same accumulator layout.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kBlockQ = 64;   // query rows per block: 4 warps x 16 rows
constexpr int kBlockK = 64;   // keys per tile of the loop
constexpr int kThreads = 128;
constexpr unsigned kFull = 0xffffffffu;
// Finite, as flash_pallas.NEG_INF: a key tile that is fully masked for a row
// gives exp(NEG_INF - NEG_INF) = 1, not NaN, and a later visible key's
// rescale exp(NEG_INF - m) = 0 wipes that out.
constexpr float kNegInf = -1e30f;

struct Params {
  const void* q;
  const void* k;
  const void* v;
  const int* seg;  // [B, S] segment ids, or null
  void* out;
  float* lse;
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

// Copies rows [row0, row0 + 64) of one head (D elements each, `stride`
// elements apart in device memory) into shared memory with row stride LD.
// Rows past `nrows` and columns past D are zero.
template <typename T, int DP>
__device__ __forceinline__ void load_tile(T* dst, const T* src, size_t stride, int row0,
                                          int nrows, int D) {
  constexpr int kVec = 16 / sizeof(T);
  constexpr int kChunks = DP / kVec;
  constexpr int LD = DP + kVec;
  for (int c = threadIdx.x; c < kBlockK * kChunks; c += kThreads) {
    const int r = c / kChunks;
    const int col = (c % kChunks) * kVec;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (row0 + r < nrows && col < D) {
      val = __ldg(reinterpret_cast<const uint4*>(src + (size_t)(row0 + r) * stride + col));
    }
    *reinterpret_cast<uint4*>(dst + r * LD + col) = val;
  }
}

template <typename T>
__device__ __forceinline__ void store2(T* dst, float x, float y) {
  if constexpr (std::is_same<T, float>::value) {
    *reinterpret_cast<float2*>(dst) = make_float2(x, y);
  } else {
    *reinterpret_cast<uint32_t*>(dst) = pack2<T>(x, y);
  }
}

// DP: head_dim rounded up to 64, 128 or 256 (columns past D are zero).
//
// Accumulator layout (that of mma m16n8): lane = 4 * gid + tig owns rows
// gid and gid + 8 of its warp's 16, and columns 2 * tig, 2 * tig + 1 of each
// 8-wide column tile: s[j][0..1] / o[n][0..1] for row gid, [2..3] for gid + 8.
template <typename T, int DP>
__global__ void __launch_bounds__(kThreads) flash_fwd_kernel(const Params p) {
  constexpr bool kF32 = std::is_same<T, float>::value;
  constexpr int LD = DP + 16 / sizeof(T);  // padded row stride: no bank conflicts
  constexpr int NT = kBlockK / 8;          // 8-key column tiles of S
  constexpr int NO = DP / 8;               // 8-wide column tiles of O

  extern __shared__ __align__(16) unsigned char smem[];
  T* q_s = reinterpret_cast<T*>(smem);
  T* k_s = q_s + kBlockQ * LD;
  T* v_s = k_s + kBlockK * LD;
  int* kseg_s = reinterpret_cast<int*>(v_s + kBlockK * LD);

  const int qt = gridDim.x - 1 - blockIdx.x;  // the longest causal rows start first
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / (p.H / p.G);
  const int q0 = qt * kBlockQ;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int gid = lane >> 2;
  const int tig = lane & 3;

  const size_t q_stride = (size_t)p.H * p.D;
  const size_t kv_stride = (size_t)p.G * p.D;
  const T* qg = static_cast<const T*>(p.q) + (size_t)b * p.Sq * q_stride + (size_t)h * p.D;
  const T* kg = static_cast<const T*>(p.k) + (size_t)b * p.Sk * kv_stride + (size_t)kvh * p.D;
  const T* vg = static_cast<const T*>(p.v) + (size_t)b * p.Sk * kv_stride + (size_t)kvh * p.D;

  load_tile<T, DP>(q_s, qg, q_stride, q0, p.Sq, p.D);

  const int row0 = q0 + warp * 16 + gid;
  const int row1 = row0 + 8;
  int seg0 = 0, seg1 = 0;
  if (p.seg != nullptr) {
    seg0 = row0 < p.Sq ? p.seg[(size_t)b * p.Sq + row0] : 0;
    seg1 = row1 < p.Sq ? p.seg[(size_t)b * p.Sq + row1] : 0;
  }

  // The band of key tiles (flash_pallas._k_band / _block_visible): from the
  // first tile holding a key inside the window of the block's first row, to
  // the tile holding the block's last row when causal.
  int kt_lo = 0;
  int kt_hi = (p.Sk + kBlockK - 1) / kBlockK;
  if (p.causal) kt_hi = min(kt_hi, (q0 + kBlockQ - 1) / kBlockK + 1);
  if (p.window > 0) kt_lo = max(0, q0 - p.window + 1) / kBlockK;
  const bool masked = p.causal || p.window > 0 || p.seg != nullptr;

  float o[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n) {
#pragma unroll
    for (int e = 0; e < 4; ++e) o[n][e] = 0.f;
  }
  float m0 = kNegInf, m1 = kNegInf, l0 = 0.f, l1 = 0.f;
  const T* qw = q_s + warp * 16 * LD;

  for (int kt = kt_lo; kt < kt_hi; ++kt) {
    const int k0 = kt * kBlockK;
    __syncthreads();  // every warp is done with the previous tile
    load_tile<T, DP>(k_s, kg, kv_stride, k0, p.Sk, p.D);
    load_tile<T, DP>(v_s, vg, kv_stride, k0, p.Sk, p.D);
    if (p.seg != nullptr && threadIdx.x < kBlockK) {
      const int kr = k0 + threadIdx.x;
      kseg_s[threadIdx.x] = kr < p.Sk ? p.seg[(size_t)b * p.Sk + kr] : 0;
    }
    __syncthreads();

    // S = Q K^T for this warp's 16 rows and the tile's 64 keys.
    float s[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
    }
    if constexpr (kF32) {
#pragma unroll 4
      for (int d = 0; d < DP; d += 2) {
        const float2 qa = *reinterpret_cast<const float2*>(qw + gid * LD + d);
        const float2 qb = *reinterpret_cast<const float2*>(qw + (gid + 8) * LD + d);
#pragma unroll
        for (int j = 0; j < NT; ++j) {
          const float2 ka = *reinterpret_cast<const float2*>(k_s + (8 * j + 2 * tig) * LD + d);
          const float2 kb = *reinterpret_cast<const float2*>(k_s + (8 * j + 2 * tig + 1) * LD + d);
          s[j][0] += qa.x * ka.x + qa.y * ka.y;
          s[j][1] += qa.x * kb.x + qa.y * kb.y;
          s[j][2] += qb.x * ka.x + qb.y * ka.y;
          s[j][3] += qb.x * kb.x + qb.y * kb.y;
        }
      }
    } else {
#pragma unroll
      for (int kk = 0; kk < DP / 16; ++kk) {
        const T* qa = qw + gid * LD + kk * 16 + 2 * tig;
        const uint32_t a[4] = {ld32(qa), ld32(qa + 8 * LD), ld32(qa + 8), ld32(qa + 8 * LD + 8)};
#pragma unroll
        for (int j = 0; j < NT; ++j) {
          const T* kp = k_s + (8 * j + gid) * LD + kk * 16 + 2 * tig;
          const uint32_t bf[2] = {ld32(kp), ld32(kp + 8)};
          mma16816<T>(s[j], a, bf);
        }
      }
    }

    // Scale, softcap BEFORE the mask (tanh(NEG_INF) would unmask), mask.
#pragma unroll
    for (int j = 0; j < NT; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = e < 2 ? row0 : row1;
        const int col = k0 + 8 * j + 2 * tig + (e & 1);
        float x = s[j][e] * p.sm_scale;
        if (p.softcap > 0.f) x = p.softcap * tanhf(x / p.softcap);
        bool keep = col < p.Sk;
        if (masked) {
          if (p.causal) keep = keep && col <= row;
          if (p.window > 0) keep = keep && col > row - p.window;
          if (p.seg != nullptr) keep = keep && kseg_s[col - k0] == (e < 2 ? seg0 : seg1);
        }
        s[j][e] = keep ? x : kNegInf;
      }
    }

    // Online softmax: rows are spread over the 4 lanes of a quad.
    float mx0 = m0, mx1 = m1;
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      mx0 = fmaxf(mx0, fmaxf(s[j][0], s[j][1]));
      mx1 = fmaxf(mx1, fmaxf(s[j][2], s[j][3]));
    }
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      mx0 = fmaxf(mx0, __shfl_xor_sync(kFull, mx0, off));
      mx1 = fmaxf(mx1, __shfl_xor_sync(kFull, mx1, off));
    }
    const float alpha0 = __expf(m0 - mx0);
    const float alpha1 = __expf(m1 - mx1);
    float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      s[j][0] = __expf(s[j][0] - mx0);
      s[j][1] = __expf(s[j][1] - mx0);
      s[j][2] = __expf(s[j][2] - mx1);
      s[j][3] = __expf(s[j][3] - mx1);
      sum0 += s[j][0] + s[j][1];
      sum1 += s[j][2] + s[j][3];
    }
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      sum0 += __shfl_xor_sync(kFull, sum0, off);
      sum1 += __shfl_xor_sync(kFull, sum1, off);
    }
    l0 = alpha0 * l0 + sum0;
    l1 = alpha1 * l1 + sum1;
    m0 = mx0;
    m1 = mx1;
#pragma unroll
    for (int n = 0; n < NO; ++n) {
      o[n][0] *= alpha0;
      o[n][1] *= alpha0;
      o[n][2] *= alpha1;
      o[n][3] *= alpha1;
    }

    // O += P V, with P rounded to the input type (flash_pallas :142-143).
    if constexpr (kF32) {
      // P row entries live on the quad's lanes; fetch each key's by shuffle.
#pragma unroll
      for (int jj = 0; jj < kBlockK; ++jj) {
        const int src = (lane & ~3) | ((jj & 7) >> 1);
        const float p0 = __shfl_sync(kFull, s[jj >> 3][jj & 1], src);
        const float p1 = __shfl_sync(kFull, s[jj >> 3][2 + (jj & 1)], src);
        const float* vr = v_s + jj * LD + 2 * tig;
#pragma unroll
        for (int n = 0; n < NO; ++n) {
          const float2 vv = *reinterpret_cast<const float2*>(vr + 8 * n);
          o[n][0] += p0 * vv.x;
          o[n][1] += p0 * vv.y;
          o[n][2] += p1 * vv.x;
          o[n][3] += p1 * vv.y;
        }
      }
    } else {
      // Two adjacent 8-key tiles of S in accumulator layout are exactly the
      // A operand of one m16n8k16 product.
#pragma unroll
      for (int kk = 0; kk < kBlockK / 16; ++kk) {
        const uint32_t a[4] = {pack2<T>(s[2 * kk][0], s[2 * kk][1]),
                               pack2<T>(s[2 * kk][2], s[2 * kk][3]),
                               pack2<T>(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                               pack2<T>(s[2 * kk + 1][2], s[2 * kk + 1][3])};
        const T* vrow = v_s + (kk * 16 + (lane & 15)) * LD;
#pragma unroll
        for (int n = 0; n < NO; ++n) {
          uint32_t bf[2];
          ldsm_x2_trans(bf[0], bf[1], vrow + 8 * n);
          mma16816<T>(o[n], a, bf);
        }
      }
    }
  }

  const float L0 = l0 == 0.f ? 1.f : l0;
  const float L1 = l1 == 0.f ? 1.f : l1;
  T* og = static_cast<T*>(p.out) + (size_t)b * p.Sq * q_stride + (size_t)h * p.D;
#pragma unroll
  for (int n = 0; n < NO; ++n) {
    const int col = 8 * n + 2 * tig;
    if (col < p.D) {
      if (row0 < p.Sq) store2<T>(og + (size_t)row0 * q_stride + col, o[n][0] / L0, o[n][1] / L0);
      if (row1 < p.Sq) store2<T>(og + (size_t)row1 * q_stride + col, o[n][2] / L1, o[n][3] / L1);
    }
  }
  if (tig == 0) {
    float* lg = p.lse + ((size_t)b * p.H + h) * p.Sq;
    if (row0 < p.Sq) lg[row0] = m0 + logf(L0);
    if (row1 < p.Sq) lg[row1] = m1 + logf(L1);
  }
}

template <typename T, int DP>
cudaError_t launch(const Params& p, int B, cudaStream_t stream) {
  constexpr int LD = DP + 16 / sizeof(T);
  const size_t smem = (size_t)(kBlockQ + 2 * kBlockK) * LD * sizeof(T) + kBlockK * sizeof(int);
  // Above 48 KB (D=128 in 16-bit types already is) only as opted-in dynamic memory.
  cudaError_t err = cudaFuncSetAttribute(flash_fwd_kernel<T, DP>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((p.Sq + kBlockQ - 1) / kBlockQ, p.H, B);
  flash_fwd_kernel<T, DP><<<grid, kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_for_dim(const Params& p, int B, cudaStream_t stream) {
  if (p.D <= 64) return launch<T, 64>(p, B, stream);
  if (p.D <= 128) return launch<T, 128>(p, B, stream);
  return launch<T, 256>(p, B, stream);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16, 2 = float16. The caller has checked
// shapes, types, contiguity, 16-byte alignment, D % 16 == 0 and D <= 256.
// Returns the launch's cudaError_t (0 on success).
extern "C" int flash_fwd(const void* q, const void* k, const void* v, const int* seg, void* out,
                         float* lse, int dtype, int B, int H, int G, int Sq, int Sk, int D,
                         float sm_scale, float softcap, int causal, int window, void* stream) {
  const Params p{q, k, v, seg, out, lse, H, G, Sq, Sk, D, sm_scale, softcap, causal, window};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return (int)launch_for_dim<float>(p, B, s);
    case 1: return (int)launch_for_dim<__nv_bfloat16>(p, B, s);
    case 2: return (int)launch_for_dim<__half>(p, B, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

extern "C" const char* flash_fwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
