// Flash-attention dK/dV backward kernel for Hopper (sm_90a) on wgmma, TMA
// and warp specialisation, written by hand: the route of 16-bit inputs at
// head_dim 64 and 128 (flash_cuda._wgmma_route), beside flash_bwd_dq_sm90.cu
// on the same route. Everything else takes flash_bwd.cu's kernels.
//
// Replaces the TPU kernel accelerate_tpu/ops/flash_pallas.py::_bwd_dkdv_kernel
// (launched by _flash_bwd): dV += P^T dO and dK += dS^T Q over the q band
// (flash_pallas._q_band) and the rep query heads of each kv head, with P =
// exp(s - lse) recomputed from the forward's logsumexp, dP = dO V^T and dS =
// P * (dP - delta) * softcap chain * sm_scale (delta = rowsum(dO * O), from
// the wrapper). The softcap chain 1 - (s_cap / cap)^2 takes the pre-mask
// s_cap; a masked pair gets P = dS = 0 directly, so an empty row gives zeros.
// P and dS are rounded to the input type before their products, as the TPU
// kernel does. Inputs and outputs are flash_bwd.cu's: q/dO [B, Sq, H, D],
// k/v/dK/dV [B, Sk, G, D], lse/delta [B, H, Sq] f32.
//
// What bounds it: four products per visible (q, k) pair, 8 * D operations.
// At the training shape (B=8, S=1024, H=16, G=8, D=128, causal, bf16) that
// is 6.88e10 operations over ~135 MB, at the Llama-3-8B main-path shape (B=4,
// S=2048, H=32, G=8) 2.75e11 over ~270 MB: the tensor-core rate bounds it
// (0.070 and 0.278 ms at 989 TFLOP/s).
//
// Design. A block owns 128 keys of one (batch, kv head) (512 blocks at the
// training shape): two warpgroups of 64 keys each, 256 threads. K and V are
// loaded once by TMA; Q and dO stream in 64-row tiles through a 3-stage ring
// under full/empty mbarriers, each tile issued by warp 0 two tiles ahead of
// its use, with its rows of lse and delta beside it. S^T = K.Q^T and dP^T =
// V.dO^T are wgmma m64n64k16 chains with both operands in shared memory.
// P^T and dS^T stay in registers and are the register A operand of dV +=
// P^T.dO and dK += dS^T.Q (wgmma m64nDk16, dO and Q as MN-major B). dK and
// dV accumulate in f32 registers (64 + 64 a thread at D=128) and are written
// once: every output has one writer and there are no atomics, so repeat
// launches are bit-identical. Only tiles where the diagonal, the window's
// edge, a segment boundary or a ragged end falls take the per-element mask;
// a warpgroup skips the products of a tile its keys cannot see. Key tile 0
// has the most causal work and is launched first.
//
// Registers, and why there is no producer warp: a thread holds dK and dV
// (128 f32 at D=128) beside S^T and dP^T (64). An SM's registers sit in four
// partitions of 16K, one per warp scheduler, so a ninth warp puts three
// warps on one of them and caps every thread at 168 registers when ptxas
// compiles, where these products spill and are serialised; setmaxnreg moves
// registers only at run time. Eight warps may use 255.
//
// Left for later: overlap of the next tile's S^T/dP^T with this tile's
// elementwise work, a persistent grid, and 64-key blocks if the tail wave
// costs more than the larger tile gains.

#include "sm90.cuh"

namespace {

using namespace sm90;

constexpr int kBlockN = 128;   // keys per block: two warpgroups x 64
constexpr int kBlockM = 64;    // query rows per streamed tile
constexpr int kStages = 3;     // Q/dO ring depth
constexpr int kThreads = 256;  // two warpgroups of 64 keys
constexpr float kLog2e = 1.4426950408889634f;

struct Params {
  CUtensorMap tm_q;
  CUtensorMap tm_k;
  CUtensorMap tm_v;
  CUtensorMap tm_do;
  const float* lse;    // [B, H, Sq]
  const float* delta;  // [B, H, Sq]
  const int* seg;      // [B, S] segment ids, or null
  void* dk;
  void* dv;
  int H, G, Sq, Sk;
  float sm_scale;
  float softcap;  // <= 0: none
  int causal;
  int window;     // <= 0: none
};

// Shared memory, every tile 1024-byte aligned: K and V [boxes][128 keys][64],
// Q[stage] and dO[stage] [boxes][64 rows][64], the tile's rows of lse and
// delta per stage, then the barriers.
template <int D>
struct Layout {
  static constexpr int kKV = kBlockN * D * 2;
  static constexpr int kQ = kBlockM * D * 2;
  static constexpr int kK = 0;
  static constexpr int kV = kKV;
  static constexpr int kQs = 2 * kKV;
  static constexpr int kDo = kQs + kStages * kQ;
  static constexpr int kRows = kDo + kStages * kQ;  // [stage][lse, delta][64] f32
  static constexpr int kBar = kRows + kStages * 2 * kBlockM * 4;
  static constexpr int kBytes = kBar + (1 + 2 * kStages) * 8;
  static constexpr int kAlloc = kBytes + 1024;
};

// P^T and dS^T of one tile, rounded to T, as the register A fragments of
// the dV and dK products: st holds S^T, dpt dP^T (rows: the thread's keys
// key0 / key0 + 8; entry j: query q0 + 8 * (j / 4) + 2t + (j & 1)). Entries
// j, j + 1 are neighbouring queries and one packed word, so each pair of f32
// values dies as its word is made. lse and delta are read from shared
// memory pair by pair: loads from device memory would be hoisted ahead of
// the products into registers that dK and dV need.
struct Tile {
  const float* lse;    // the tile's 64 rows of lse (shared memory)
  const float* delta;  // and of delta
  const int* seg;      // the batch's segment ids [S] (device memory), or null
  int key0, q0, t;     // the thread's first key, the tile's first query, lane % 4
};

template <typename T, bool kMask, bool kCap>
__device__ __forceinline__ void tile_grads(const float (&st)[32], const float (&dpt)[32],
                                           uint32_t (&pa)[4][4], uint32_t (&da)[4][4],
                                           const Params& p, const Tile& w) {
  const float scale2 = p.sm_scale * kLog2e;
#pragma unroll
  for (int j = 0; j < 32; j += 2) {
    float prob[2], ds[2];
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int q = w.q0 + 8 * (j >> 2) + 2 * w.t + e;
      const bool in = q < p.Sq;
      const float lse2 = w.lse[q - w.q0] * kLog2e;  // 0 past Sq: those rows are masked
      const float delta = w.delta[q - w.q0];
      float x2, chain = 1.f;
      if constexpr (kCap) {
        const float xc = p.softcap * tanhf(st[j + e] * p.sm_scale / p.softcap);  // pre-mask s_cap
        const float u = xc / p.softcap;
        chain = 1.f - u * u;
        x2 = xc * kLog2e;
      } else {
        x2 = st[j + e] * scale2;
      }
      prob[e] = fast_exp2(x2 - lse2);
      if constexpr (kMask) {
        const int key = (j & 2) ? w.key0 + 8 : w.key0;
        bool keep = in && key < p.Sk;
        if (p.causal) keep = keep && key <= q;
        if (p.window > 0) keep = keep && key > q - p.window;
        if (w.seg != nullptr) keep = keep && w.seg[q] == w.seg[key];  // L1 hits
        if (!keep) prob[e] = 0.f;
      }
      ds[e] = prob[e] * (dpt[j + e] - delta) * chain * p.sm_scale;
    }
    pa[j / 8][(j % 8) / 2] = pack2<T>(prob[0], prob[1]);
    da[j / 8][(j % 8) / 2] = pack2<T>(ds[0], ds[1]);
  }
}

// Warp 0 issues tile `j` of the block's (head, q tile) sequence into its
// stage once both warpgroups have released the tile that held it: lane 0
// the TMA loads of Q and dO, every lane cp.async copies of two rows of lse
// and delta (zeros past Sq), all completing on the stage's full barrier.
template <int D>
__device__ __forceinline__ void issue_tile(const Params& p, uint8_t* smem, uint64_t* full,
                                           uint64_t* empty, int j, int n_q, int qt_lo, int g,
                                           int rep, int b, int lane) {
  using L = Layout<D>;
  const int s = j % kStages;
  const int h = g * rep + j / n_q;
  const int q0 = (qt_lo + j % n_q) * kBlockM;
  if (lane == 0) mbar_wait(&empty[s], ((j / kStages) & 1) ^ 1);
  __syncwarp();
  float* rows = reinterpret_cast<float*>(smem + L::kRows) + s * 2 * kBlockM;
  const size_t row_off = ((size_t)b * p.H + h) * p.Sq;
  for (int r = lane; r < kBlockM; r += 32) {
    const bool in = q0 + r < p.Sq;
    const size_t src = row_off + (in ? q0 + r : 0);
    cp_async_4(rows + r, p.lse + src, in);
    cp_async_4(rows + kBlockM + r, p.delta + src, in);
  }
  cp_async_arrive(&full[s]);
  if (lane == 0) {
    mbar_arrive_expect_tx(&full[s], 2 * L::kQ);
    for (int x = 0; x < D / 64; ++x) {
      tma_load_4d(smem + L::kQs + s * L::kQ + x * kBlockM * 128, &p.tm_q, &full[s], 64 * x, h,
                  q0, b);
      tma_load_4d(smem + L::kDo + s * L::kQ + x * kBlockM * 128, &p.tm_do, &full[s], 64 * x, h,
                  q0, b);
    }
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads, 1)
    flash_bwd_dkdv_sm90_kernel(const __grid_constant__ Params p) {
  using L = Layout<D>;
  constexpr int kBoxes = D / 64;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = aligned_smem(smem_raw);
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + L::kBar);
  uint64_t* kv_full = bars;
  uint64_t* full = bars + 1;
  uint64_t* empty = bars + 1 + kStages;

  const int g = blockIdx.x;
  const int b = blockIdx.y;
  const int k0 = blockIdx.z * kBlockN;  // key tile 0, the longest causal band, starts first
  const int rep = p.H / p.G;
  const int wg = warpgroup_index();
  const int lane = threadIdx.x % 32;

  // The band of query tiles (flash_pallas._q_band / _block_visible): causal
  // queries start at the block's first key; a window ends at its last key + w - 1.
  const int nq = (p.Sq + kBlockM - 1) / kBlockM;
  int qt_lo = 0, qt_hi = nq;
  if (p.causal) qt_lo = min(nq, k0 / kBlockM);
  if (p.window > 0) qt_hi = min(nq, (k0 + kBlockN - 1 + p.window - 1) / kBlockM + 1);
  const int n_q = max(0, qt_hi - qt_lo);
  const int n_tiles = rep * n_q;

  if (threadIdx.x == 0) {
    mbar_init(kv_full, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 33);  // warp 0's lanes' copies and lane 0's bytes
      mbar_init(&empty[s], 8);  // every warp
    }
    fence_barrier_init();
  }
  __syncthreads();
  const bool issuer = warpgroup_index() == 0 && warp_in_warpgroup() == 0;  // warp 0
  if (issuer) {
    if (lane == 0) {
      mbar_arrive_expect_tx(kv_full, 2 * L::kKV);
      for (int x = 0; x < kBoxes; ++x) {
        tma_load_4d(smem + L::kK + x * kBlockN * 128, &p.tm_k, kv_full, 64 * x, g, k0, b);
        tma_load_4d(smem + L::kV + x * kBlockN * 128, &p.tm_v, kv_full, 64 * x, g, k0, b);
      }
    }
    for (int j = 0; j < min(kStages - 1, n_tiles); ++j) {
      issue_tile<D>(p, smem, full, empty, j, n_q, qt_lo, g, rep, b, lane);
    }
  }

  const int gi = lane / 4;
  const int t = lane % 4;
  const int kw0 = k0 + wg * 64;  // this warpgroup's keys
  const int key0 = kw0 + warp_in_warpgroup() * 16 + gi;  // and key0 + 8
  const int* seg_row = p.seg == nullptr ? nullptr : p.seg + (size_t)b * p.Sq;
  float dk[D / 2], dv[D / 2];
#pragma unroll
  for (int j = 0; j < D / 2; ++j) dk[j] = dv[j] = 0.f;
  const uint8_t* k_wg = smem + L::kK + wg * 64 * 128;
  const uint8_t* v_wg = smem + L::kV + wg * 64 * 128;

  mbar_wait(kv_full, 0);
  for (int it = 0; it < n_tiles; ++it) {
    if (issuer && it + kStages - 1 < n_tiles) {
      issue_tile<D>(p, smem, full, empty, it + kStages - 1, n_q, qt_lo, g, rep, b, lane);
    }
    const int s = it % kStages;
    const uint32_t ph = (it / kStages) & 1;
    const int q0 = (qt_lo + it % n_q) * kBlockM;
    const uint8_t* q_tile = smem + L::kQs + s * L::kQ;
    const uint8_t* do_tile = smem + L::kDo + s * L::kQ;
    const float* rows = reinterpret_cast<const float*>(smem + L::kRows) + s * 2 * kBlockM;
    mbar_wait(&full[s], ph);
    const bool visible = (!p.causal || q0 + kBlockM - 1 >= kw0) &&
                         (p.window <= 0 || q0 <= kw0 + 63 + p.window - 1);
    if (visible) {
      float st[32], dpt[32];
      const uint64_t k_desc = desc_sw128(k_wg, 16, 1024);
      const uint64_t v_desc = desc_sw128(v_wg, 16, 1024);
      const uint64_t q_desc = desc_sw128(q_tile, 16, 1024);
      const uint64_t do_desc = desc_sw128(do_tile, 16, 1024);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {  // S^T = K Q^T
        wgmma_ss<T, 64>(st, k_desc + kmajor_step(kk, kBlockN), q_desc + kmajor_step(kk, kBlockM),
                        kk > 0);
      }
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {  // dP^T = V dO^T
        wgmma_ss<T, 64>(dpt, v_desc + kmajor_step(kk, kBlockN),
                        do_desc + kmajor_step(kk, kBlockM), kk > 0);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(st);
      fence_regs(dpt);

      const bool mask = (p.causal && kw0 + 63 > q0) ||
                        (p.window > 0 && q0 + kBlockM - 1 >= kw0 + p.window) ||
                        q0 + kBlockM > p.Sq || kw0 + 64 > p.Sk || p.seg != nullptr;
      const Tile w{rows, rows + kBlockM, seg_row, key0, q0, t};
      uint32_t pa[4][4], da[4][4];
      if (p.softcap > 0.f) {
        if (mask) tile_grads<T, true, true>(st, dpt, pa, da, p, w);
        else tile_grads<T, false, true>(st, dpt, pa, da, p, w);
      } else {
        if (mask) tile_grads<T, true, false>(st, dpt, pa, da, p, w);
        else tile_grads<T, false, false>(st, dpt, pa, da, p, w);
      }
      const uint64_t do_mn = desc_sw128(do_tile, kBlockM * 128, 1024);
      const uint64_t q_mn = desc_sw128(q_tile, kBlockM * 128, 1024);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kBlockM / 16; ++kk) {  // dV += P^T dO
        wgmma_rs<T, D>(dv, pa[kk], do_mn + mnmajor_step(kk), 1);
      }
#pragma unroll
      for (int kk = 0; kk < kBlockM / 16; ++kk) {  // dK += dS^T Q
        wgmma_rs<T, D>(dk, da[kk], q_mn + mnmajor_step(kk), 1);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(dv);
      fence_regs(dk);
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[s]);
  }

  const size_t kv_stride = (size_t)p.G * D;
  const size_t kv_off = (size_t)b * p.Sk * kv_stride + (size_t)g * D;
  T* dkg = static_cast<T*>(p.dk) + kv_off;
  T* dvg = static_cast<T*>(p.dv) + kv_off;
  const int key1 = key0 + 8;
#pragma unroll
  for (int n = 0; n < D / 8; ++n) {
    const int col = 8 * n + 2 * t;
    if (key0 < p.Sk) {
      store2<T>(dkg + (size_t)key0 * kv_stride + col, dk[4 * n], dk[4 * n + 1]);
      store2<T>(dvg + (size_t)key0 * kv_stride + col, dv[4 * n], dv[4 * n + 1]);
    }
    if (key1 < p.Sk) {
      store2<T>(dkg + (size_t)key1 * kv_stride + col, dk[4 * n + 2], dk[4 * n + 3]);
      store2<T>(dvg + (size_t)key1 * kv_stride + col, dv[4 * n + 2], dv[4 * n + 3]);
    }
  }
}

template <typename T, int D>
int launch(const Params& p, int B, cudaStream_t stream) {
  using L = Layout<D>;
  const cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dkdv_sm90_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize, L::kAlloc);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(p.G, B, (p.Sk + kBlockN - 1) / kBlockN);
  flash_bwd_dkdv_sm90_kernel<T, D><<<grid, kThreads, L::kAlloc, stream>>>(p);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 1 = bfloat16, 2 = float16; D is 64 or 128. The caller has checked
// shapes, types, contiguity and 16-byte alignment. Returns 0, a cudaError_t,
// or a tensor-map encoding failure (flash_bwd_dkdv_sm90_error_string says
// which).
extern "C" int flash_bwd_dkdv_sm90(const void* q, const void* k, const void* v, const void* dout,
                                   const float* lse, const float* delta, const int* seg,
                                   void* dk, void* dv, int dtype, int B, int H, int G, int Sq,
                                   int Sk, int D, float sm_scale, float softcap, int causal,
                                   int window, void* stream) {
  if ((dtype != 1 && dtype != 2) || (D != 64 && D != 128) || Sq <= 0) {
    return (int)cudaErrorInvalidValue;
  }
  if (B == 0 || Sk == 0) return 0;
  Params p{};
  int err = make_map_bshd(&p.tm_q, q, dtype, B, Sq, H, D, kBlockM);
  if (err == 0) err = make_map_bshd(&p.tm_do, dout, dtype, B, Sq, H, D, kBlockM);
  if (err == 0) err = make_map_bshd(&p.tm_k, k, dtype, B, Sk, G, D, kBlockN);
  if (err == 0) err = make_map_bshd(&p.tm_v, v, dtype, B, Sk, G, D, kBlockN);
  if (err != 0) return err;
  p.lse = lse;
  p.delta = delta;
  p.seg = seg;
  p.dk = dk;
  p.dv = dv;
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

extern "C" const char* flash_bwd_dkdv_sm90_error_string(int code) { return error_string(code); }
