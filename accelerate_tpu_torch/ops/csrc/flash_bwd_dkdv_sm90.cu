// Flash-attention dK/dV backward kernel for Hopper (sm_90a) on wgmma, TMA
// and warp specialisation, written by hand: the route of 16-bit inputs at
// head_dim 64, 80, 96, 128 and 256 (flash_cuda._wgmma_route("dkdv", ...)).
// float32 inputs and any other head_dim take flash_bwd.cu's
// flash_bwd_dkdv_kernel. The dQ kernel of the same call takes its own route
// (flash_bwd_dq_sm90.cu at the same head_dims, else flash_bwd.cu).
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
// What bounds it: four products per visible (q, k) pair, 8 * D operations,
// against each input read once and dK, dV written once: the tensor-core rate
// bounds it at every D it takes (at 989 TFLOP/s): 0.070 and 0.278 ms at the
// training (B=8, S=1024, H=16, G=8, D=128, causal, bf16) and the Llama-3-8B
// (B=4, S=2048, H=32, G=8) shapes; at B=8, S=1024 with G = H, 0.087 ms for
// Phi-2 (H=32, D=80), 0.209 ms for GPT-NeoX-20B (H=64, D=96) and 0.139 ms
// for GPT-J-6B (H=16, D=256).
//
// Design. A block owns kBlockN keys of one (batch, kv head), 256 threads in
// two warpgroups. K and V are loaded once by TMA; Q and dO stream in 64-row
// tiles through a ring under full/empty mbarriers, each tile issued by warp
// 0 ahead of its use, with its rows of lse and delta beside it. S^T = K.Q^T
// and dP^T = V.dO^T are wgmma m64n64k16 chains with both operands in shared
// memory. P^T and dS^T stay in registers and are the register A operand of
// dV += P^T.dO and dK += dS^T.Q (dO and Q as MN-major B). dK and dV
// accumulate in f32 registers and are written once: every output has one
// writer and there are no atomics, so repeat launches are bit-identical.
// Only tiles where the diagonal, the window's edge, a segment boundary or a
// ragged end falls take the per-element mask; a warpgroup skips the
// products of a tile its keys cannot see. Key tile 0 has the most causal
// work and is launched first.
//
// Per head_dim (Config, and sm90.cuh's Panels for the tile layout):
// - D=64 and 128: 128 keys a block, 64 a warpgroup, a 3-stage ring; dK and
//   dV are 32 + 32 or 64 + 64 registers a thread.
// - D=80 and 96 (Phi-2, GPT-NeoX) are not a whole number of 128-byte
//   swizzle atoms: every tile is a 64-column panel under the 128-byte
//   swizzle and a tail panel of 16 or 32 columns under the 32- or 64-byte
//   swizzle. S^T and dP^T take D/16 k-steps, the last ones from the tail;
//   dV and dK are an n64 product and an n16/n32 product over the tail a
//   k-slice, so they cover D columns (40 or 48 registers each), not 128.
// - D=256 (GPT-J, Gemma2): dK and dV of 64 keys at full width would be 256
//   registers a thread, and 128 keys would need 128 + 3 x 64 KB of shared
//   memory. A block owns 64 keys, and the two warpgroups split D: warpgroup
//   w holds columns 128w..128w+127 of dK and dV (64 + 64 registers), and
//   both need P^T and dS^T of all 64 keys. So warpgroup 0 computes S^T and
//   warpgroup 1 dP^T (the same products once, as at the other D); through 16
//   KB of shared memory each hands its partner the half of its tile the
//   partner's 32 queries need, each computes P^T and dS^T of its 32
//   queries, and the halves are swapped back as packed A fragments. Thread
//   i of one warpgroup trades only with thread i of the other, a
//   __syncthreads between writes and reads. A 2-stage Q/dO ring: 64 + 2 x
//   64 + 16 KB.
//
// Registers, and why there is no producer warp: a thread holds dK and dV
// (up to 128 f32) beside S^T and dP^T (64). An SM's registers sit in four
// partitions of 16K, one per warp scheduler, so a ninth warp puts three
// warps on one of them and caps every thread at 168 registers when ptxas
// compiles, where these products spill and are serialised; setmaxnreg moves
// registers only at run time. Eight warps may use 255, and ptxas reports no
// spill at any D.
//
// Left for later: overlap of the next tile's S^T/dP^T with this tile's
// elementwise work, a persistent grid, and 64-key blocks below D=256 if the
// tail wave costs more than the larger tile gains.

#include "sm90.cuh"

namespace {

using namespace sm90;

constexpr int kBlockM = 64;    // query rows per streamed tile
constexpr int kThreads = 256;  // two warpgroups
constexpr float kLog2e = 1.4426950408889634f;

struct Params {
  CUtensorMap tm_q, tm_q_tail;  // the 64-column panels and, at D = 80 or 96, the tail
  CUtensorMap tm_k, tm_k_tail;
  CUtensorMap tm_v, tm_v_tail;
  CUtensorMap tm_do, tm_do_tail;
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

// Tiles and shared memory per head_dim, every tile 1024-byte aligned: K and
// V [kBlockN keys x D], Q[stage] and dO[stage] [64 rows x D], each in
// Panels<D> order, the tile's rows of lse and delta per stage, at D=256 the
// warpgroups' exchange [2][16][128] words, then the barriers.
template <int D>
struct Config {
  static constexpr bool kSplit = D > 128;           // the warpgroups share the keys, split D
  static constexpr int kBlockN = kSplit ? 64 : 128;  // keys per block
  static constexpr int kStages = kSplit ? 2 : 3;     // Q/dO ring depth
  static constexpr int kCols = kSplit ? D / 2 : D;   // dK/dV columns a warpgroup holds
  static constexpr int kKV = kBlockN * D * 2;
  static constexpr int kQ = kBlockM * D * 2;
  static constexpr int kK = 0;
  static constexpr int kV = kKV;
  static constexpr int kQs = 2 * kKV;
  static constexpr int kDo = kQs + kStages * kQ;
  static constexpr int kRows = kDo + kStages * kQ;  // [stage][lse, delta][64] f32
  static constexpr int kX = kRows + kStages * 2 * kBlockM * 4;
  static constexpr int kBar = kX + (kSplit ? 2 * 16 * 128 * 4 : 0);
  static constexpr int kBytes = kBar + (1 + 2 * kStages) * 8;
  static constexpr int kAlloc = kBytes + 1024;
  static_assert(kAlloc <= 232448, "more shared memory than a block may have");
};

// P^T and dS^T of one tile, rounded to T, as the register A fragments of
// the dV and dK products: st holds S^T, dpt dP^T (rows: the thread's keys
// key0 / key0 + 8; entry j: query q0 + 8 * (j / 4) + 2t + (j & 1)), N
// entries giving N / 8 k16 slices. Entries j, j + 1 are neighbouring
// queries and one packed word, so each pair of f32 values dies as its word
// is made. lse and delta are read from shared memory pair by pair: loads
// from device memory would be hoisted ahead of the products into registers
// that dK and dV need.
struct Tile {
  const float* lse;    // the rows of lse from query q0 on (shared memory)
  const float* delta;  // and of delta
  const int* seg;      // the batch's segment ids [S] (device memory), or null
  int key0, q0, t;     // the thread's first key, entry 0's query, lane % 4
};

template <typename T, bool kMask, bool kCap, int N>
__device__ __forceinline__ void tile_grads(const float (&st)[N], const float (&dpt)[N],
                                           uint32_t (&pa)[N / 8][4], uint32_t (&da)[N / 8][4],
                                           const Params& p, const Tile& w) {
  const float scale2 = p.sm_scale * kLog2e;
#pragma unroll
  for (int j = 0; j < N; j += 2) {
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

template <typename T, int N>
__device__ __forceinline__ void grads_of(const float (&st)[N], const float (&dpt)[N],
                                         uint32_t (&pa)[N / 8][4], uint32_t (&da)[N / 8][4],
                                         const Params& p, const Tile& w, bool mask) {
  if (p.softcap > 0.f) {
    if (mask) tile_grads<T, true, true>(st, dpt, pa, da, p, w);
    else tile_grads<T, false, true>(st, dpt, pa, da, p, w);
  } else {
    if (mask) tile_grads<T, true, false>(st, dpt, pa, da, p, w);
    else tile_grads<T, false, false>(st, dpt, pa, da, p, w);
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
  using C = Config<D>;
  const int s = j % C::kStages;
  const int h = g * rep + j / n_q;
  const int q0 = (qt_lo + j % n_q) * kBlockM;
  if (lane == 0) mbar_wait(&empty[s], ((j / C::kStages) & 1) ^ 1);
  __syncwarp();
  float* rows = reinterpret_cast<float*>(smem + C::kRows) + s * 2 * kBlockM;
  const size_t row_off = ((size_t)b * p.H + h) * p.Sq;
  for (int r = lane; r < kBlockM; r += 32) {
    const bool in = q0 + r < p.Sq;
    const size_t src = row_off + (in ? q0 + r : 0);
    cp_async_4(rows + r, p.lse + src, in);
    cp_async_4(rows + kBlockM + r, p.delta + src, in);
  }
  cp_async_arrive(&full[s]);
  if (lane == 0) {
    mbar_arrive_expect_tx(&full[s], 2 * C::kQ);
    tma_load_tile<D>(smem + C::kQs + s * C::kQ, &p.tm_q, &p.tm_q_tail, &full[s], kBlockM, h, q0,
                     b);
    tma_load_tile<D>(smem + C::kDo + s * C::kQ, &p.tm_do, &p.tm_do_tail, &full[s], kBlockM, h,
                     q0, b);
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads, 1)
    flash_bwd_dkdv_sm90_kernel(const __grid_constant__ Params p) {
  using C = Config<D>;
  constexpr int kN = C::kBlockN;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = aligned_smem(smem_raw);
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + C::kBar);
  uint64_t* kv_full = bars;
  uint64_t* full = bars + 1;
  uint64_t* empty = bars + 1 + C::kStages;

  const int g = blockIdx.x;
  const int b = blockIdx.y;
  const int k0 = blockIdx.z * kN;  // key tile 0, the longest causal band, starts first
  const int rep = p.H / p.G;
  const int wg = warpgroup_index();
  const int lane = threadIdx.x % 32;

  // The band of query tiles (flash_pallas._q_band / _block_visible): causal
  // queries start at the block's first key; a window ends at its last key + w - 1.
  const int nq = (p.Sq + kBlockM - 1) / kBlockM;
  int qt_lo = 0, qt_hi = nq;
  if (p.causal) qt_lo = min(nq, k0 / kBlockM);
  if (p.window > 0) qt_hi = min(nq, (k0 + kN - 1 + p.window - 1) / kBlockM + 1);
  const int n_q = max(0, qt_hi - qt_lo);
  const int n_tiles = rep * n_q;

  if (threadIdx.x == 0) {
    mbar_init(kv_full, 1);
    for (int s = 0; s < C::kStages; ++s) {
      mbar_init(&full[s], 33);  // warp 0's lanes' copies and lane 0's bytes
      mbar_init(&empty[s], 8);  // every warp
    }
    fence_barrier_init();
  }
  __syncthreads();
  const bool issuer = warpgroup_index() == 0 && warp_in_warpgroup() == 0;  // warp 0
  if (issuer) {
    if (lane == 0) {
      mbar_arrive_expect_tx(kv_full, 2 * C::kKV);
      tma_load_tile<D>(smem + C::kK, &p.tm_k, &p.tm_k_tail, kv_full, kN, g, k0, b);
      tma_load_tile<D>(smem + C::kV, &p.tm_v, &p.tm_v_tail, kv_full, kN, g, k0, b);
    }
    for (int j = 0; j < min(C::kStages - 1, n_tiles); ++j) {
      issue_tile<D>(p, smem, full, empty, j, n_q, qt_lo, g, rep, b, lane);
    }
  }

  const int gi = lane / 4;
  const int t = lane % 4;
  const int kw0 = C::kSplit ? k0 : k0 + wg * 64;  // this warpgroup's keys
  const int key0 = kw0 + warp_in_warpgroup() * 16 + gi;  // and key0 + 8
  const int* seg_row = p.seg == nullptr ? nullptr : p.seg + (size_t)b * p.Sq;
  float dk[C::kCols / 2], dv[C::kCols / 2];
#pragma unroll
  for (int j = 0; j < C::kCols / 2; ++j) dk[j] = dv[j] = 0.f;

  mbar_wait(kv_full, 0);
  for (int it = 0; it < n_tiles; ++it) {
    if (issuer && it + C::kStages - 1 < n_tiles) {
      issue_tile<D>(p, smem, full, empty, it + C::kStages - 1, n_q, qt_lo, g, rep, b, lane);
    }
    const int s = it % C::kStages;
    const uint32_t ph = (it / C::kStages) & 1;
    const int q0 = (qt_lo + it % n_q) * kBlockM;
    const uint8_t* q_tile = smem + C::kQs + s * C::kQ;
    const uint8_t* do_tile = smem + C::kDo + s * C::kQ;
    const float* rows = reinterpret_cast<const float*>(smem + C::kRows) + s * 2 * kBlockM;
    mbar_wait(&full[s], ph);
    // Whether this warpgroup's keys see any query of the tile (at D=256 both
    // warpgroups hold the same keys, so both skip or neither does).
    const bool visible = (!p.causal || q0 + kBlockM - 1 >= kw0) &&
                         (p.window <= 0 || q0 <= kw0 + 63 + p.window - 1);
    // Whether the tile needs the per-element mask (read after the products).
    auto masked = [&]() {
      return (p.causal && kw0 + 63 > q0) || (p.window > 0 && q0 + kBlockM - 1 >= kw0 + p.window) ||
             q0 + kBlockM > p.Sq || kw0 + 64 > p.Sk || p.seg != nullptr;
    };
    if (visible) {
      if constexpr (!C::kSplit) {
        float st[32], dpt[32];
        const KDesc k_desc = kmajor_descs<D>(smem + C::kK, kN, wg * 64);
        const KDesc v_desc = kmajor_descs<D>(smem + C::kV, kN, wg * 64);
        const KDesc q_desc = kmajor_descs<D>(q_tile, kBlockM);
        const KDesc do_desc = kmajor_descs<D>(do_tile, kBlockM);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk) {  // S^T = K Q^T
          wgmma_ss<T, 64>(st, kmajor_slice<D>(k_desc, kk, kN),
                          kmajor_slice<D>(q_desc, kk, kBlockM), kk > 0);
        }
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk) {  // dP^T = V dO^T
          wgmma_ss<T, 64>(dpt, kmajor_slice<D>(v_desc, kk, kN),
                          kmajor_slice<D>(do_desc, kk, kBlockM), kk > 0);
        }
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(st);
        fence_regs(dpt);
        uint32_t pa[4][4], da[4][4];
        grads_of<T>(st, dpt, pa, da, p, Tile{rows, rows + kBlockM, seg_row, key0, q0, t},
                    masked());
        const KDesc do_mn = mnmajor_descs<D>(do_tile, kBlockM);
        const KDesc q_mn = mnmajor_descs<D>(q_tile, kBlockM);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < kBlockM / 16; ++kk) {  // dV += P^T dO
          wgmma_rs_d<T, D>(dv, pa[kk], do_mn, kk, kBlockM);
        }
#pragma unroll
        for (int kk = 0; kk < kBlockM / 16; ++kk) {  // dK += dS^T Q
          wgmma_rs_d<T, D>(dk, da[kk], q_mn, kk, kBlockM);
        }
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(dv);
        fence_regs(dk);
      } else {
        // Warpgroup 0: S^T = K Q^T; warpgroup 1: dP^T = V dO^T.
        float acc[32];
        const KDesc a_desc = kmajor_descs<D>(smem + (wg == 0 ? C::kK : C::kV), kN);
        const KDesc b_desc = kmajor_descs<D>(wg == 0 ? q_tile : do_tile, kBlockM);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk) {
          wgmma_ss<T, 64>(acc, kmajor_slice<D>(a_desc, kk, kN),
                          kmajor_slice<D>(b_desc, kk, kBlockM), kk > 0);
        }
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(acc);
        // Entries 0-15 are queries q0..q0+31, entries 16-31 the next 32.
        // Warpgroup w keeps its product on queries 32w.. and hands the other
        // half to its partner (thread i of the other warpgroup): round 1
        // writes x[w], reads x[1 - w]; round 2 writes x[1 - w], reads x[w].
        float* x = reinterpret_cast<float*>(smem + C::kX);
        uint32_t* xw = reinterpret_cast<uint32_t*>(x);
        const int tid = threadIdx.x % 128;
        float keep[16];
#pragma unroll
        for (int r = 0; r < 16; ++r) {
          keep[r] = wg == 0 ? acc[r] : acc[16 + r];
          x[(wg * 16 + r) * 128 + tid] = wg == 0 ? acc[16 + r] : acc[r];
        }
        __syncthreads();
        float st[16], dpt[16];
#pragma unroll
        for (int r = 0; r < 16; ++r) {
          const float got = x[((1 - wg) * 16 + r) * 128 + tid];
          st[r] = wg == 0 ? keep[r] : got;
          dpt[r] = wg == 0 ? got : keep[r];
        }
        uint32_t ph2[2][4], dh2[2][4];  // P^T, dS^T of this warpgroup's 32 queries
        grads_of<T>(st, dpt, ph2, dh2, p,
                    Tile{rows + 32 * wg, rows + kBlockM + 32 * wg, seg_row, key0, q0 + 32 * wg, t},
                    masked());
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          xw[((1 - wg) * 16 + i) * 128 + tid] = ph2[i / 4][i % 4];
          xw[((1 - wg) * 16 + 8 + i) * 128 + tid] = dh2[i / 4][i % 4];
        }
        __syncthreads();
        uint32_t pa[4][4], da[4][4];  // k16 slices 0-1 from warpgroup 0, 2-3 from 1
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const uint32_t gp = xw[(wg * 16 + i) * 128 + tid];
          const uint32_t gd = xw[(wg * 16 + 8 + i) * 128 + tid];
          pa[i / 4][i % 4] = wg == 0 ? ph2[i / 4][i % 4] : gp;
          pa[2 + i / 4][i % 4] = wg == 0 ? gp : ph2[i / 4][i % 4];
          da[i / 4][i % 4] = wg == 0 ? dh2[i / 4][i % 4] : gd;
          da[2 + i / 4][i % 4] = wg == 0 ? gd : dh2[i / 4][i % 4];
        }
        // This warpgroup's columns of dV and dK: panels 2w and 2w + 1.
        const uint64_t do_mn = desc_sw128(do_tile + 2 * wg * kBlockM * 128, kBlockM * 128, 1024);
        const uint64_t q_mn = desc_sw128(q_tile + 2 * wg * kBlockM * 128, kBlockM * 128, 1024);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < kBlockM / 16; ++kk) {  // dV += P^T dO
          wgmma_rs<T, C::kCols>(dv, pa[kk], do_mn + mnmajor_step(kk), 1);
        }
#pragma unroll
        for (int kk = 0; kk < kBlockM / 16; ++kk) {  // dK += dS^T Q
          wgmma_rs<T, C::kCols>(dk, da[kk], q_mn + mnmajor_step(kk), 1);
        }
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(dv);
        fence_regs(dk);
      }
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[s]);
  }

  const size_t kv_stride = (size_t)p.G * D;
  const int col0 = C::kSplit ? wg * C::kCols : 0;  // this warpgroup's first column
  const size_t kv_off = (size_t)b * p.Sk * kv_stride + (size_t)g * D + col0;
  T* dkg = static_cast<T*>(p.dk) + kv_off;
  T* dvg = static_cast<T*>(p.dv) + kv_off;
  const int key1 = key0 + 8;
#pragma unroll
  for (int n = 0; n < C::kCols / 8; ++n) {
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

// The tensor maps of one call at head_dim D, then the kernel of (T, D).
template <int D>
int launch(Params p, const void* q, const void* k, const void* v, const void* dout, int dtype,
           int B, cudaStream_t stream) {
  using C = Config<D>;
  int err = make_maps_bshd<D>(&p.tm_q, &p.tm_q_tail, q, dtype, B, p.Sq, p.H, kBlockM);
  if (err == 0) {
    err = make_maps_bshd<D>(&p.tm_do, &p.tm_do_tail, dout, dtype, B, p.Sq, p.H, kBlockM);
  }
  if (err == 0) err = make_maps_bshd<D>(&p.tm_k, &p.tm_k_tail, k, dtype, B, p.Sk, p.G, C::kBlockN);
  if (err == 0) err = make_maps_bshd<D>(&p.tm_v, &p.tm_v_tail, v, dtype, B, p.Sk, p.G, C::kBlockN);
  if (err != 0) return err;
  auto kernel = dtype == 1 ? flash_bwd_dkdv_sm90_kernel<__nv_bfloat16, D>
                           : flash_bwd_dkdv_sm90_kernel<__half, D>;
  const cudaError_t set =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, C::kAlloc);
  if (set != cudaSuccess) return (int)set;
  const dim3 grid(p.G, B, (p.Sk + C::kBlockN - 1) / C::kBlockN);
  kernel<<<grid, kThreads, C::kAlloc, stream>>>(p);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 1 = bfloat16, 2 = float16; D is 64, 80, 96, 128 or 256, and any
// other D is refused. The caller has checked shapes, types, contiguity and
// 16-byte alignment. Returns 0, a cudaError_t, or a tensor-map encoding
// failure (flash_bwd_dkdv_sm90_error_string says which).
extern "C" int flash_bwd_dkdv_sm90(const void* q, const void* k, const void* v, const void* dout,
                                   const float* lse, const float* delta, const int* seg,
                                   void* dk, void* dv, int dtype, int B, int H, int G, int Sq,
                                   int Sk, int D, float sm_scale, float softcap, int causal,
                                   int window, void* stream) {
  if ((dtype != 1 && dtype != 2) || Sq <= 0) return (int)cudaErrorInvalidValue;
  if (D != 64 && D != 80 && D != 96 && D != 128 && D != 256) return (int)cudaErrorInvalidValue;
  if (B == 0 || Sk == 0) return 0;
  Params p{};
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
  switch (D) {
    case 64: return launch<64>(p, q, k, v, dout, dtype, B, s);
    case 80: return launch<80>(p, q, k, v, dout, dtype, B, s);
    case 96: return launch<96>(p, q, k, v, dout, dtype, B, s);
    case 128: return launch<128>(p, q, k, v, dout, dtype, B, s);
    default: return launch<256>(p, q, k, v, dout, dtype, B, s);
  }
}

extern "C" const char* flash_bwd_dkdv_sm90_error_string(int code) { return error_string(code); }
