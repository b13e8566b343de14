// Flash-attention forward for Hopper (sm_90a) on wgmma and TMA, written by
// hand: the route of 16-bit inputs at head_dim 64, 80, 96, 128 and 256
// (flash_cuda._wgmma_route("forward", ...)). float32 inputs and any other
// head_dim take flash_fwd.cu.
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
// What bounds it: two products per visible (q, k) pair, 4 * D operations,
// against each input read once. Causal over S keys that is H * S / (2 (H +
// G)) operations a byte whatever D is, ~500 or more at S=2048, so the
// tensor-core rate bounds it at every D it takes (at 989 TFLOP/s): 0.035
// and 0.139 ms at the training (B=8, S=1024, H=16, G=8) and the Llama-3-8B
// (B=4, S=2048, H=32, G=8) shapes at D=128; at B=4, S=2048 with G = H,
// 0.087 ms for Phi-2 (H=32, D=80), 0.209 ms for GPT-NeoX-20B (H=64, D=96)
// and 0.139 ms for GPT-J-6B (H=16, D=256); Gemma2-9B (H=16, G=8, D=256)
// has GPT-J's products.
//
// Design. A block owns 128 query rows of one (batch, head): two warpgroups of
// 64 rows, 256 threads. Thread 0 loads Q once by TMA and streams K and V
// tiles through two rings in shared memory, each with a full and an empty
// barrier per stage: a K tile can be released once its S product is done
// and a V tile once its P.V product is (both go at the end of the step
// that finishes P.V), and each tile is issued a whole step before its use.
// S = Q.K^T is a wgmma chain with both operands in shared memory; the
// softmax runs in registers; P, rounded to the input type, is the register
// A operand of O += P.V (V as an MN-major B). Within a
// warpgroup the products of two tiles overlap the softmax: tile j's S and
// tile j-1's P.V are issued together, the softmax of tile j runs while P.V
// finishes, and O is rescaled after it. Only tiles where the causal
// diagonal, the window's edge, a segment boundary or the ragged end of the
// keys falls take the per-element mask. The band of key tiles is
// flash_pallas._k_band's, visited from the diagonal down (so the first tile
// sets every row's max); the heaviest causal q tiles are launched first.
//
// Per head_dim (Config, and sm90.cuh's Panels for the tile layout):
// - D=64 and 128: 128-key tiles, a 2-deep K ring and a 3-deep V ring (16 +
//   5 x 16 KB and 32 + 5 x 32 KB); S is m64n128 (64 registers), O 32 or 64.
// - D=80 and 96 (Phi-2, GPT-NeoX) are not a whole number of 128-byte
//   swizzle atoms. A tile is a 64-column panel under the 128-byte swizzle
//   and a tail panel of 16 or 32 columns under the 32- or 64-byte swizzle,
//   each a TMA box of its own. S takes D/16 k-steps (5 or 6), the last ones
//   from the tail; O += P.V is an n64 product and an n16 or n32 product over
//   the tail, so the products and O (40 or 48 registers) cover D columns,
//   not D rounded up to 128 as flash_fwd.cu does. Shared memory: 20 + 5 x
//   20 KB and 24 + 5 x 24 KB.
// - D=256 (GPT-J, Gemma2): a 128-key tile would need 64 + 3 x 128 KB of
//   shared memory and 128 + 64 + 32 registers for O, S and P. The K/V tile
//   is 64 keys, both rings 2 deep (64 + 4 x 32 KB); S is m64n64 (32
//   registers), P 16, O 128, and O += P.V two n128 products a k-slice.
//
// Registers, and why there is no producer warp: a thread holds O, S and P
// across the overlap. An SM's registers sit in four partitions of 16K, one
// per warp scheduler, so a ninth warp puts three warps on one of them and
// caps every thread at 168 registers when ptxas compiles; setmaxnreg moves
// registers only at run time. Eight warps may use 255, and ptxas reports
// no spill at any D.
//
// Left for later: a persistent grid over the tiles (one block fits per SM,
// so a block's prologue and epilogue run with the SM otherwise idle), fewer
// K/V reads (a K/V tile serves 128 query rows; two blocks of one kv head
// could share it by cluster multicast), and a TMA store of O through shared
// memory. Ping-pong of the two warpgroups' products (FlashAttention-3's
// schedule) made no difference at D=128.

#include "sm90.cuh"

namespace {

using namespace sm90;

constexpr int kBlockM = 128;   // query rows per block: two warpgroups x 64
constexpr int kThreads = 256;  // two warpgroups
constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

struct Params {
  CUtensorMap tm_q, tm_q_tail;  // the 64-column panels and, at D = 80 or 96, the tail
  CUtensorMap tm_k, tm_k_tail;
  CUtensorMap tm_v, tm_v_tail;
  void* out;
  float* lse;
  const int* seg;  // [B, S] segment ids, or null
  int H, G, Sq, Sk;
  float sm_scale;
  float softcap;  // <= 0: none
  int causal;
  int window;     // <= 0: none
};

// Tiles, rings and shared memory per head_dim, every tile 1024-byte
// aligned: Q [128 rows x D], K[kStagesK] and V[kStagesV] [kBlockN keys x
// D], each in Panels<D> order, then the barriers (Q full; K full, K empty;
// V full, V empty).
template <int D>
struct Config {
  static constexpr int kBlockN = D > 128 ? 64 : 128;  // keys per K/V tile
  static constexpr int kStagesK = 2;                  // the tile in use and the next
  static constexpr int kStagesV = D > 128 ? 2 : 3;    // and, where it fits, one more
  static constexpr int kS = kBlockN / 2;              // S entries a thread
  static constexpr int kSlices = kBlockN / 16;        // k16 slices of P.V
  static constexpr int kQ = kBlockM * D * 2;
  static constexpr int kKV = kBlockN * D * 2;
  static constexpr int kK = kQ;
  static constexpr int kV = kK + kStagesK * kKV;
  static constexpr int kBar = kV + kStagesV * kKV;
  static constexpr int kBytes = kBar + (1 + 2 * kStagesK + 2 * kStagesV) * 8;
  static constexpr int kAlloc = kBytes + 1024;
  static_assert(kAlloc <= 232448, "more shared memory than a block may have");
};

// Scale (and softcap) the logits of one tile into log2 units, masking
// invisible pairs to -1e30 when kMask. Column j of S is key k0 + 8 * (j / 4)
// + 2t + (j & 1); entries j % 4 < 2 are row `row`, the others row + 8.
// `kseg` is the batch's segment ids (device memory, L1 hits), or null.
template <bool kMask, bool kCap, int N>
__device__ __forceinline__ void scale_and_mask(float (&s)[N], const Params& p, int row, int k0,
                                               int t, const int* kseg, int seg0, int seg1) {
  const float scale2 = p.sm_scale * kLog2e;
#pragma unroll
  for (int j = 0; j < N; ++j) {
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
template <int N>
__device__ __forceinline__ void softmax_step(float (&s)[N], float& m0, float& m1, float& l0,
                                             float& l1, float& a0, float& a1) {
  float mx0 = m0, mx1 = m1;
#pragma unroll
  for (int i = 0; i < N / 4; ++i) {
    mx0 = fmaxf(mx0, fmaxf(s[4 * i], s[4 * i + 1]));
    mx1 = fmaxf(mx1, fmaxf(s[4 * i + 2], s[4 * i + 3]));
  }
#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {  // a row's entries sit on the 4 lanes of a quad
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
  }
  a0 = fast_exp2(m0 - mx0);
  a1 = fast_exp2(m1 - mx1);
  m0 = mx0;
  m1 = mx1;
  float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
  for (int i = 0; i < N / 4; ++i) {
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

// Thread 0 issues the K (or V) tile `j` of the band (from the diagonal
// down) into stage j % kStages of its ring, at shared-memory offset `base`,
// once every warp has released the tile that held the stage.
template <int D, int kStages>
__device__ __forceinline__ void issue_tile(const CUtensorMap* map, const CUtensorMap* tail,
                                           uint8_t* smem, int base, uint64_t* full,
                                           uint64_t* empty, int j, int kt_hi, int kvh, int b) {
  using C = Config<D>;
  const int s = j % kStages;
  const int k0 = (kt_hi - 1 - j) * C::kBlockN;
  mbar_wait(&empty[s], ((j / kStages) & 1) ^ 1);
  mbar_arrive_expect_tx(&full[s], C::kKV);
  tma_load_tile<D>(smem + base + s * C::kKV, map, tail, &full[s], C::kBlockN, kvh, k0, b);
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads, 1)
    flash_fwd_sm90_kernel(const __grid_constant__ Params p) {
  using C = Config<D>;
  constexpr int kN = C::kBlockN;
  constexpr int kSK = C::kStagesK;
  constexpr int kSV = C::kStagesV;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = aligned_smem(smem_raw);
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + C::kBar);
  uint64_t* q_full = bars;
  uint64_t* k_full = bars + 1;
  uint64_t* k_empty = k_full + kSK;
  uint64_t* v_full = k_empty + kSK;
  uint64_t* v_empty = v_full + kSV;

  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int q0 = (gridDim.z - 1 - blockIdx.z) * kBlockM;  // the longest causal rows start first
  const int kvh = h / (p.H / p.G);
  const int wg = warpgroup_index();
  const int lane = threadIdx.x % 32;

  // The band of key tiles (flash_pallas._k_band / _block_visible).
  const int nk = (p.Sk + kN - 1) / kN;
  int kt_hi = nk;
  int kt_lo = 0;
  if (p.causal) kt_hi = min(nk, (q0 + kBlockM - 1) / kN + 1);
  if (p.window > 0) kt_lo = max(0, q0 - p.window + 1) / kN;
  const int n_tiles = max(0, kt_hi - kt_lo);
  auto issue_k = [&](int j) {
    issue_tile<D, kSK>(&p.tm_k, &p.tm_k_tail, smem, C::kK, k_full, k_empty, j, kt_hi, kvh, b);
  };
  auto issue_v = [&](int j) {
    issue_tile<D, kSV>(&p.tm_v, &p.tm_v_tail, smem, C::kV, v_full, v_empty, j, kt_hi, kvh, b);
  };

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < kSK; ++s) {
      mbar_init(&k_full[s], 1);
      mbar_init(&k_empty[s], 8);  // every warp
    }
    for (int s = 0; s < kSV; ++s) {
      mbar_init(&v_full[s], 1);
      mbar_init(&v_empty[s], 8);
    }
    fence_barrier_init();
    mbar_arrive_expect_tx(q_full, C::kQ);
    tma_load_tile<D>(smem, &p.tm_q, &p.tm_q_tail, q_full, kBlockM, h, q0, b);
    for (int j = 0; j < min(kSK, n_tiles); ++j) issue_k(j);
    for (int j = 0; j < min(kSV - 1, n_tiles); ++j) issue_v(j);
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
  float sacc[C::kS];
  uint32_t pa[C::kSlices][4];  // P of the tile whose P.V is next, as A fragments
  const KDesc q_desc = kmajor_descs<D>(smem, kBlockM, wg * 64);  // this warpgroup's rows

  // The products read only registers written before their wgmma.fence:
  // descriptors are made first, and the barrier waits write none of them.
  auto k_desc = [&](int it) { return kmajor_descs<D>(smem + C::kK + (it % kSK) * C::kKV, kN); };
  auto v_desc = [&](int it) { return mnmajor_descs<D>(smem + C::kV + (it % kSV) * C::kKV, kN); };
  // S = Q K^T of tile `it` into sacc; committed, not waited for.
  auto issue_s = [&](const KDesc& kd) {
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      wgmma_ss<T, kN>(sacc, kmajor_slice<D>(q_desc, kk, kBlockM), kmajor_slice<D>(kd, kk, kN),
                      kk > 0);
    }
    wgmma_commit();
  };
  // O += P V of the tile whose P is in pa; committed, not waited for.
  auto issue_pv = [&](const KDesc& vd) {
#pragma unroll
    for (int kk = 0; kk < C::kSlices; ++kk) wgmma_rs_d<T, D>(o, pa[kk], vd, kk, kN);
    wgmma_commit();
  };
  auto wait_k = [&](int it) { mbar_wait(&k_full[it % kSK], (it / kSK) & 1); };
  auto wait_v = [&](int it) { mbar_wait(&v_full[it % kSV], (it / kSV) & 1); };
  auto release = [&](uint64_t* empty) {
    __syncwarp();
    if (lane == 0) mbar_arrive(empty);
  };
  auto scale_mask = [&](int it) {
    const int k0 = (kt_hi - 1 - it) * kN;
    const bool mask = (p.causal && k0 + kN - 1 > row_lo) ||
                      (p.window > 0 && k0 < row_hi - p.window + 1) || k0 + kN > p.Sk ||
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
    KDesc kd = k_desc(0);
    wait_k(0);
    wgmma_fence();
    issue_s(kd);
    wgmma_wait<0>();
    fence_regs(sacc);
    release(&k_empty[0]);
    scale_mask(0);
    float a0, a1;
    softmax_step(sacc, m0, m1, l0, l1, a0, a1);
#pragma unroll
    for (int kk = 0; kk < C::kSlices; ++kk) pack_a<T>(pa[kk], sacc, kk);
    for (int it = 1; it < n_tiles; ++it) {
      if (threadIdx.x == 0) {
        if (it + kSK - 1 < n_tiles) issue_k(it + kSK - 1);
        if (it + kSV - 2 < n_tiles) issue_v(it + kSV - 2);
      }
      // This tile's S and the last tile's P.V in flight together; the
      // softmax of this tile runs while P.V finishes.
      kd = k_desc(it);
      const KDesc vd = v_desc(it - 1);
      wait_k(it);
      wait_v(it - 1);
      wgmma_fence();
      issue_s(kd);
      issue_pv(vd);
      wgmma_wait<1>();
      fence_regs(sacc);
      scale_mask(it);
      softmax_step(sacc, m0, m1, l0, l1, a0, a1);
      wgmma_wait<0>();
      fence_regs(o);
      // K of this tile and V of the last one, released together: one warp
      // sync on the softmax's path, as with one ring.
      __syncwarp();
      if (lane == 0) {
        mbar_arrive(&k_empty[it % kSK]);
        mbar_arrive(&v_empty[(it - 1) % kSV]);
      }
#pragma unroll
      for (int n = 0; n < D / 8; ++n) {
        o[4 * n] *= a0;
        o[4 * n + 1] *= a0;
        o[4 * n + 2] *= a1;
        o[4 * n + 3] *= a1;
      }
#pragma unroll
      for (int kk = 0; kk < C::kSlices; ++kk) pack_a<T>(pa[kk], sacc, kk);
    }
    const KDesc vd = v_desc(n_tiles - 1);
    wait_v(n_tiles - 1);
    wgmma_fence();
    issue_pv(vd);
    wgmma_wait<0>();
    fence_regs(o);
    release(&v_empty[(n_tiles - 1) % kSV]);
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

// The tensor maps of one call at head_dim D, then the kernel of (T, D).
template <int D>
int launch(Params p, const void* q, const void* k, const void* v, int dtype, int B,
           cudaStream_t stream) {
  using C = Config<D>;
  int err = make_maps_bshd<D>(&p.tm_q, &p.tm_q_tail, q, dtype, B, p.Sq, p.H, kBlockM);
  if (err == 0) err = make_maps_bshd<D>(&p.tm_k, &p.tm_k_tail, k, dtype, B, p.Sk, p.G, C::kBlockN);
  if (err == 0) err = make_maps_bshd<D>(&p.tm_v, &p.tm_v_tail, v, dtype, B, p.Sk, p.G, C::kBlockN);
  if (err != 0) return err;
  auto kernel =
      dtype == 1 ? flash_fwd_sm90_kernel<__nv_bfloat16, D> : flash_fwd_sm90_kernel<__half, D>;
  const cudaError_t set =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, C::kAlloc);
  if (set != cudaSuccess) return (int)set;
  const dim3 grid(p.H, B, (p.Sq + kBlockM - 1) / kBlockM);
  kernel<<<grid, kThreads, C::kAlloc, stream>>>(p);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 1 = bfloat16, 2 = float16; D is 64, 80, 96, 128 or 256, and any
// other D is refused. The caller has checked shapes, types, contiguity and
// 16-byte alignment. Returns 0, a cudaError_t, or a tensor-map encoding
// failure (flash_fwd_sm90_error_string says which).
extern "C" int flash_fwd_sm90(const void* q, const void* k, const void* v, const int* seg,
                              void* out, float* lse, int dtype, int B, int H, int G, int Sq,
                              int Sk, int D, float sm_scale, float softcap, int causal,
                              int window, void* stream) {
  if ((dtype != 1 && dtype != 2) || Sk <= 0) return (int)cudaErrorInvalidValue;
  if (D != 64 && D != 80 && D != 96 && D != 128 && D != 256) return (int)cudaErrorInvalidValue;
  if (B == 0 || Sq == 0) return 0;
  Params p{};
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
  switch (D) {
    case 64: return launch<64>(p, q, k, v, dtype, B, s);
    case 80: return launch<80>(p, q, k, v, dtype, B, s);
    case 96: return launch<96>(p, q, k, v, dtype, B, s);
    case 128: return launch<128>(p, q, k, v, dtype, B, s);
    default: return launch<256>(p, q, k, v, dtype, B, s);
  }
}

extern "C" const char* flash_fwd_sm90_error_string(int code) { return error_string(code); }
