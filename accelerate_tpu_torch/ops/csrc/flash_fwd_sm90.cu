// Flash-attention forward for Hopper (sm_90a) on wgmma and TMA, written by
// hand: the route of 16-bit inputs at head_dim 64 and 128
// (flash_cuda._wgmma_route). Everything else takes flash_fwd.cu.
//
// Replaces the TPU kernel accelerate_tpu/ops/flash_pallas.py::_fwd_kernel
// (launched by _flash_fwd): tiled online-softmax attention with a running
// max m, sum l and f32 accumulator per query row, O = acc / l (l == 0 -> 1)
// and the logsumexp residual lse = m + log l for the backward pass. Inputs
// and outputs are flash_fwd.cu's: q [B, Sq, H, D], k/v [B, Sk, G, D], out
// [B, Sq, H, D] in q's type, lse [B, H, Sq] f32; query head h reads kv head
// h / (H / G); causal, a banded sliding window, segment ids, the softcap
// before the mask and sm_scale; masked logits take the finite -1e30, so a
// tile with no visible key for a row adds exp(0) = 1 that the first visible
// key's rescale exp(-1e30 - m) = 0 wipes out, as in flash_fwd.cu.
//
// What bounds it: two products per visible (q, k) pair, 4 * D operations.
// At the training shape (B=8, S=1024, H=16, G=8, D=128, causal, bf16) that
// is 3.44e10 operations over ~101 MB, at the Llama-3-8B main-path shape
// (B=4, S=2048, H=32, G=8) 1.38e11 over ~169 MB: ~800 operations a byte,
// so the tensor-core rate bounds it (0.035 and 0.139 ms at 989 TFLOP/s).
//
// Design. A block owns 128 query rows of one (batch, head): two warpgroups of
// 64 rows, 256 threads. Thread 0 loads Q once by TMA and streams K and V in
// 128-key tiles through a 3-stage ring in shared memory (32 + 3 x 64 KB at
// D=128, one block per SM) under a full barrier for K, one for V and an empty
// barrier per stage: a tile is issued a whole step before its use, while the
// ring still holds the tile before it, whose V is in use. S = Q.K^T is a
// wgmma m64n128k16 chain with both operands in shared memory; the softmax
// runs in registers; P, rounded to the input type, is the register A operand
// of O += P.V (wgmma m64nDk16, V as an MN-major B). Within a warpgroup the
// products of two tiles overlap the softmax: tile j's S and tile j-1's P.V
// are issued together, the softmax of tile j runs while P.V finishes, and O
// is rescaled after it. Only tiles where the causal diagonal, the window's
// edge, a segment boundary or the ragged end of the keys falls take the per-
// element mask. The band of key tiles is flash_pallas._k_band's, visited from
// the diagonal down (so the first tile sets every row's max); the heaviest
// causal q tiles are launched first.
//
// Registers, and why there is no producer warp: a thread holds O (64 f32 at
// D=128), S (64) and P (32 packed) across the overlap. An SM's registers
// sit in four partitions of 16K, one per warp scheduler, so a ninth warp
// puts three warps on one of them and caps every thread at 168 registers
// when ptxas compiles; setmaxnreg moves registers only at run time.
//
// Left for later: a persistent grid over the tiles (one block fits per SM,
// so a block's prologue and epilogue run with the SM otherwise idle), fewer
// K/V reads (a K/V tile serves 128 query rows; two blocks of one kv head
// could share it by cluster multicast), and a TMA store of O through shared
// memory. Ping-pong of the two warpgroups' products (FlashAttention-3's
// schedule) made no difference here.

#include "sm90.cuh"

namespace {

using namespace sm90;

constexpr int kBlockM = 128;   // query rows per block: two warpgroups x 64
constexpr int kBlockN = 128;   // keys per K/V tile
constexpr int kStages = 3;     // K/V ring depth: the tile in use, the next, the last one's V
constexpr int kThreads = 256;  // two warpgroups
constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

struct Params {
  CUtensorMap tm_q;
  CUtensorMap tm_k;
  CUtensorMap tm_v;
  void* out;
  float* lse;
  const int* seg;  // [B, S] segment ids, or null
  int H, G, Sq, Sk;
  float sm_scale;
  float softcap;  // <= 0: none
  int causal;
  int window;     // <= 0: none
};

// Shared memory, every tile 1024-byte aligned: Q [boxes][128 rows][64],
// K[stage] and V[stage] [boxes][128 keys][64], then the barriers. At D=128
// that is 230,480 bytes with the alignment slack, of the 232,448 a block
// may have.
template <int D>
struct Layout {
  static constexpr int kQ = kBlockM * D * 2;
  static constexpr int kKV = kBlockN * D * 2;
  static constexpr int kK = kQ;
  static constexpr int kV = kK + kStages * kKV;
  static constexpr int kBar = kV + kStages * kKV;
  static constexpr int kBytes = kBar + (1 + 3 * kStages) * 8;
  static constexpr int kAlloc = kBytes + 1024;
};

// Scale (and softcap) the logits of one tile into log2 units, masking
// invisible pairs to -1e30 when kMask. Column j of S is key k0 + 8 * (j / 4)
// + 2t + (j & 1); entries j % 4 < 2 are row `row`, the others row + 8.
// `kseg` is the batch's segment ids (device memory, L1 hits), or null.
template <bool kMask, bool kCap>
__device__ __forceinline__ void scale_and_mask(float (&s)[64], const Params& p, int row, int k0,
                                               int t, const int* kseg, int seg0, int seg1) {
  const float scale2 = p.sm_scale * kLog2e;
#pragma unroll
  for (int j = 0; j < 64; ++j) {
    float x;
    if constexpr (kCap) {
      x = p.softcap * tanhf(s[j] * p.sm_scale / p.softcap) * kLog2e;
    } else {
      x = s[j] * scale2;
    }
    if constexpr (kMask) {
      const int r = (j & 2) ? row + 8 : row;
      const int c = k0 + 8 * (j >> 2) + 2 * t + (j & 1);
      bool keep = c < p.Sk;
      if (p.causal) keep = keep && c <= r;
      if (p.window > 0) keep = keep && c > r - p.window;
      if (kseg != nullptr) keep = keep && kseg[c] == ((j & 2) ? seg1 : seg0);
      if (!keep) x = kNegInf;
    }
    s[j] = x;
  }
}

// One warpgroup's online-softmax step on tile S (in log2 units): the new
// row maxima m, the rescale factor alpha of the rows' earlier sums, P =
// exp2(S - m) in place, and l = alpha * l + rowsum(P) (per thread; the quad
// is summed at the end).
__device__ __forceinline__ void softmax_step(float (&s)[64], float& m0, float& m1, float& l0,
                                             float& l1, float& a0, float& a1) {
  float mx0 = m0, mx1 = m1;
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    mx0 = fmaxf(mx0, fmaxf(s[4 * i], s[4 * i + 1]));
    mx1 = fmaxf(mx1, fmaxf(s[4 * i + 2], s[4 * i + 3]));
  }
#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {  // a row's 128 entries sit on the 4 lanes of a quad
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
  }
  a0 = fast_exp2(m0 - mx0);
  a1 = fast_exp2(m1 - mx1);
  m0 = mx0;
  m1 = mx1;
  float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    s[4 * i] = fast_exp2(s[4 * i] - mx0);
    s[4 * i + 1] = fast_exp2(s[4 * i + 1] - mx0);
    s[4 * i + 2] = fast_exp2(s[4 * i + 2] - mx1);
    s[4 * i + 3] = fast_exp2(s[4 * i + 3] - mx1);
    sum0 += s[4 * i] + s[4 * i + 1];
    sum1 += s[4 * i + 2] + s[4 * i + 3];
  }
  l0 = a0 * l0 + sum0;
  l1 = a1 * l1 + sum1;
}

// Thread 0 issues K/V tile `it` of the band (from the diagonal down) into
// its stage once both warpgroups have released the tile that held it.
template <int D>
__device__ __forceinline__ void issue_tile(const Params& p, uint8_t* smem, uint64_t* k_full,
                                           uint64_t* v_full, uint64_t* empty, int it, int kt_hi,
                                           int kvh, int b) {
  using L = Layout<D>;
  const int s = it % kStages;
  const int k0 = (kt_hi - 1 - it) * kBlockN;
  mbar_wait(&empty[s], ((it / kStages) & 1) ^ 1);
  mbar_arrive_expect_tx(&k_full[s], L::kKV);
  for (int x = 0; x < D / 64; ++x) {
    tma_load_4d(smem + L::kK + s * L::kKV + x * kBlockN * 128, &p.tm_k, &k_full[s], 64 * x, kvh,
                k0, b);
  }
  mbar_arrive_expect_tx(&v_full[s], L::kKV);
  for (int x = 0; x < D / 64; ++x) {
    tma_load_4d(smem + L::kV + s * L::kKV + x * kBlockN * 128, &p.tm_v, &v_full[s], 64 * x, kvh,
                k0, b);
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads, 1)
    flash_fwd_sm90_kernel(const __grid_constant__ Params p) {
  using L = Layout<D>;
  constexpr int kBoxes = D / 64;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = aligned_smem(smem_raw);
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + L::kBar);
  uint64_t* q_full = bars;
  uint64_t* k_full = bars + 1;
  uint64_t* v_full = bars + 1 + kStages;
  uint64_t* empty = bars + 1 + 2 * kStages;

  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int q0 = (gridDim.z - 1 - blockIdx.z) * kBlockM;  // the longest causal rows start first
  const int kvh = h / (p.H / p.G);
  const int wg = warpgroup_index();
  const int lane = threadIdx.x % 32;

  // The band of key tiles (flash_pallas._k_band / _block_visible).
  const int nk = (p.Sk + kBlockN - 1) / kBlockN;
  int kt_hi = nk;
  int kt_lo = 0;
  if (p.causal) kt_hi = min(nk, (q0 + kBlockM - 1) / kBlockN + 1);
  if (p.window > 0) kt_lo = max(0, q0 - p.window + 1) / kBlockN;
  const int n_tiles = max(0, kt_hi - kt_lo);

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&k_full[s], 1);
      mbar_init(&v_full[s], 1);
      mbar_init(&empty[s], 8);  // every warp
    }
    fence_barrier_init();
    mbar_arrive_expect_tx(q_full, L::kQ);
    for (int x = 0; x < kBoxes; ++x) {
      tma_load_4d(smem + x * kBlockM * 128, &p.tm_q, q_full, 64 * x, h, q0, b);
    }
    for (int it = 0; it < min(kStages - 1, n_tiles); ++it) {
      issue_tile<D>(p, smem, k_full, v_full, empty, it, kt_hi, kvh, b);
    }
  }
  __syncthreads();

  const int g = lane / 4;
  const int t = lane % 4;
  const int row_lo = q0 + wg * 64;
  const int row_hi = row_lo + 63;
  const int row0 = row_lo + warp_in_warpgroup() * 16 + g;  // and row0 + 8
  const int* kseg = p.seg == nullptr ? nullptr : p.seg + (size_t)b * p.Sk;
  int seg0 = 0, seg1 = 0;
  if (p.seg != nullptr) {
    seg0 = row0 < p.Sq ? p.seg[(size_t)b * p.Sq + row0] : 0;
    seg1 = row0 + 8 < p.Sq ? p.seg[(size_t)b * p.Sq + row0 + 8] : 0;
  }

  float o[D / 2];
#pragma unroll
  for (int j = 0; j < D / 2; ++j) o[j] = 0.f;
  float m0 = kNegInf, m1 = kNegInf, l0 = 0.f, l1 = 0.f;  // m in log2 units; l per thread
  float sacc[64];
  uint32_t pa[8][4];  // P of the tile whose P.V is next, as A fragments
  const uint64_t q_desc = desc_sw128(smem + wg * 64 * 128, 16, 1024);  // this warpgroup's rows

  // The products read only registers written before their wgmma.fence:
  // descriptors are made first, and the barrier waits write none of them.
  auto k_desc = [&](int it) {
    return desc_sw128(smem + L::kK + (it % kStages) * L::kKV, 16, 1024);
  };
  auto v_desc = [&](int it) {
    return desc_sw128(smem + L::kV + (it % kStages) * L::kKV, kBlockN * 128, 1024);
  };
  // S = Q K^T of tile `it` into sacc; committed, not waited for.
  auto issue_s = [&](int it, uint64_t kd) {
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      wgmma_ss<T, 128>(sacc, q_desc + kmajor_step(kk, kBlockM), kd + kmajor_step(kk, kBlockN),
                       kk > 0);
    }
    wgmma_commit();
  };
  // O += P V of the tile whose P is in pa; committed, not waited for.
  auto issue_pv = [&](uint64_t vd) {
#pragma unroll
    for (int kk = 0; kk < kBlockN / 16; ++kk) {
      wgmma_rs<T, D>(o, pa[kk], vd + mnmajor_step(kk), 1);
    }
    wgmma_commit();
  };
  auto wait_k = [&](int it) { mbar_wait(&k_full[it % kStages], (it / kStages) & 1); };
  auto wait_v = [&](int it) { mbar_wait(&v_full[it % kStages], (it / kStages) & 1); };
  auto release = [&](int it) {
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[it % kStages]);
  };
  auto scale_mask = [&](int it) {
    const int k0 = (kt_hi - 1 - it) * kBlockN;
    const bool mask = (p.causal && k0 + kBlockN - 1 > row_lo) ||
                      (p.window > 0 && k0 < row_hi - p.window + 1) || k0 + kBlockN > p.Sk ||
                      kseg != nullptr;
    if (p.softcap > 0.f) {
      if (mask) scale_and_mask<true, true>(sacc, p, row0, k0, t, kseg, seg0, seg1);
      else scale_and_mask<false, true>(sacc, p, row0, k0, t, kseg, seg0, seg1);
    } else {
      if (mask) scale_and_mask<true, false>(sacc, p, row0, k0, t, kseg, seg0, seg1);
      else scale_and_mask<false, false>(sacc, p, row0, k0, t, kseg, seg0, seg1);
    }
  };

  mbar_wait(q_full, 0);
  if (n_tiles > 0) {
    uint64_t kd = k_desc(0);
    wait_k(0);
    wgmma_fence();
    issue_s(0, kd);
    wgmma_wait<0>();
    fence_regs(sacc);
    scale_mask(0);
    float a0, a1;
    softmax_step(sacc, m0, m1, l0, l1, a0, a1);
#pragma unroll
    for (int kk = 0; kk < 8; ++kk) pack_a<T, 64>(pa[kk], sacc, kk);
    for (int it = 1; it < n_tiles; ++it) {
      if (threadIdx.x == 0 && it + kStages - 2 < n_tiles) {
        issue_tile<D>(p, smem, k_full, v_full, empty, it + kStages - 2, kt_hi, kvh, b);
      }
      // This tile's S and the last tile's P.V in flight together; the
      // softmax of this tile runs while P.V finishes.
      kd = k_desc(it);
      const uint64_t vd = v_desc(it - 1);
      wait_k(it);
      wait_v(it - 1);
      wgmma_fence();
      issue_s(it, kd);
      issue_pv(vd);
      wgmma_wait<1>();
      fence_regs(sacc);
      scale_mask(it);
      softmax_step(sacc, m0, m1, l0, l1, a0, a1);
      wgmma_wait<0>();
      fence_regs(o);
      release(it - 1);
#pragma unroll
      for (int n = 0; n < D / 8; ++n) {
        o[4 * n] *= a0;
        o[4 * n + 1] *= a0;
        o[4 * n + 2] *= a1;
        o[4 * n + 3] *= a1;
      }
#pragma unroll
      for (int kk = 0; kk < 8; ++kk) pack_a<T, 64>(pa[kk], sacc, kk);
    }
    const uint64_t vd = v_desc(n_tiles - 1);
    wait_v(n_tiles - 1);
    wgmma_fence();
    issue_pv(vd);
    wgmma_wait<0>();
    fence_regs(o);
    release(n_tiles - 1);
  }

#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, off);
    l1 += __shfl_xor_sync(0xffffffffu, l1, off);
  }
  const float L0 = l0 == 0.f ? 1.f : l0;
  const float L1 = l1 == 0.f ? 1.f : l1;
  const float r0 = 1.f / L0, r1 = 1.f / L1;
  const size_t q_stride = (size_t)p.H * D;
  T* og = static_cast<T*>(p.out) + (size_t)b * p.Sq * q_stride + (size_t)h * D;
  const int row1 = row0 + 8;
#pragma unroll
  for (int n = 0; n < D / 8; ++n) {
    const int col = 8 * n + 2 * t;
    if (row0 < p.Sq) {
      store2<T>(og + (size_t)row0 * q_stride + col, o[4 * n] * r0, o[4 * n + 1] * r0);
    }
    if (row1 < p.Sq) {
      store2<T>(og + (size_t)row1 * q_stride + col, o[4 * n + 2] * r1, o[4 * n + 3] * r1);
    }
  }
  if (t == 0) {
    float* lg = p.lse + ((size_t)b * p.H + h) * p.Sq;
    // A row that saw no visible key keeps m = -1e30, in natural units too.
    if (row0 < p.Sq) lg[row0] = (m0 == kNegInf ? kNegInf : m0 * kLn2) + logf(L0);
    if (row1 < p.Sq) lg[row1] = (m1 == kNegInf ? kNegInf : m1 * kLn2) + logf(L1);
  }
}

template <typename T, int D>
int launch(const Params& p, int B, cudaStream_t stream) {
  using L = Layout<D>;
  const cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_sm90_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize, L::kAlloc);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(p.H, B, (p.Sq + kBlockM - 1) / kBlockM);
  flash_fwd_sm90_kernel<T, D><<<grid, kThreads, L::kAlloc, stream>>>(p);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 1 = bfloat16, 2 = float16; D is 64 or 128. The caller has checked
// shapes, types, contiguity and 16-byte alignment. Returns 0, a cudaError_t,
// or a tensor-map encoding failure (flash_fwd_sm90_error_string says which).
extern "C" int flash_fwd_sm90(const void* q, const void* k, const void* v, const int* seg,
                              void* out, float* lse, int dtype, int B, int H, int G, int Sq,
                              int Sk, int D, float sm_scale, float softcap, int causal,
                              int window, void* stream) {
  if ((dtype != 1 && dtype != 2) || (D != 64 && D != 128) || Sk <= 0) {
    return (int)cudaErrorInvalidValue;
  }
  if (B == 0 || Sq == 0) return 0;
  Params p{};
  int err = make_map_bshd(&p.tm_q, q, dtype, B, Sq, H, D, kBlockM);
  if (err == 0) err = make_map_bshd(&p.tm_k, k, dtype, B, Sk, G, D, kBlockN);
  if (err == 0) err = make_map_bshd(&p.tm_v, v, dtype, B, Sk, G, D, kBlockN);
  if (err != 0) return err;
  p.out = out;
  p.lse = lse;
  p.seg = seg;
  p.H = H;
  p.G = G;
  p.Sq = Sq;
  p.Sk = Sk;
  p.sm_scale = sm_scale;
  p.softcap = softcap;
  p.causal = causal;
  p.window = window;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1) {
    return D == 64 ? launch<__nv_bfloat16, 64>(p, B, s) : launch<__nv_bfloat16, 128>(p, B, s);
  }
  return D == 64 ? launch<__half, 64>(p, B, s) : launch<__half, 128>(p, B, s);
}

extern "C" const char* flash_fwd_sm90_error_string(int code) { return error_string(code); }
