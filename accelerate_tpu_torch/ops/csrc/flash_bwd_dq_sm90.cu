// Flash-attention dQ backward kernel for Hopper (sm_90a) on wgmma and TMA,
// written by hand: the route of 16-bit inputs at head_dim 64, 80, 96, 128
// and 256 (flash_cuda._wgmma_route("dq", ...)), the head_dims of the
// dK/dV kernel (flash_bwd_dkdv_sm90.cu) that runs before it in the same
// call. float32 inputs and any other head_dim take flash_bwd.cu's
// flash_bwd_dq_kernel.
//
// Replaces the TPU kernel accelerate_tpu/ops/flash_pallas.py::_bwd_dq_kernel
// (launched by _flash_bwd): dQ += dS K over the k band (flash_pallas._k_band),
// with P = exp(s - lse) recomputed from the forward's logsumexp, dP = dO V^T
// and dS = P * (dP - delta) * softcap chain * sm_scale (delta = rowsum(dO *
// O), from the wrapper). The softcap chain 1 - (s_cap / cap)^2 takes the
// pre-mask s_cap; a masked pair gets P = dS = 0 directly, so an empty row
// gives zeros. dS is rounded to the input type before its product, as the
// TPU kernel does. Inputs and outputs are flash_bwd.cu's: q/dO/dQ [B, Sq, H,
// D], k/v [B, Sk, G, D], lse/delta [B, H, Sq] f32; query head h reads kv head
// h / (H / G).
//
// What bounds it: three products per visible (q, k) pair, 6 * D operations,
// against each input read once and dQ written once: the tensor-core rate
// bounds it at every D it takes (at 989 TFLOP/s): 0.052 and 0.209 ms at the
// training (B=8, S=1024, H=16, G=8, D=128, causal, bf16) and the Llama-3-8B
// (B=4, S=2048, H=32, G=8) shapes; at B=8, S=1024 with G = H, 0.065 ms for
// Phi-2 (H=32, D=80), 0.157 ms for GPT-NeoX-20B (H=64, D=96) and 0.104 ms
// for GPT-J-6B (H=16, D=256); 0.209 ms for Gemma2-9B (B=4, S=2048, H=16,
// G=8, D=256).
//
// Design. A block owns kBlockM query rows of one (batch, head), 256 threads
// in two warpgroups. Thread 0 loads Q and dO once by TMA and streams K and V
// in 64-key tiles through a ring under a full and an empty mbarrier per
// stage. lse and delta of the thread's two rows are read into registers
// before the loop, sm_scale folded into lse as -log2|sm_scale|. S = Q.K^T
// and dP = dO.V^T are wgmma m64n64k16 chains with both operands K-major in
// shared memory; dS is computed in registers and, rounded to the input type,
// is the register A operand of dQ += dS.K, which reads the same K tile
// through an MN-major descriptor. dQ accumulates in f32 registers and each
// output element is written once by one thread: no atomics, so repeat
// launches are bit-identical. The elementwise dS, more than the products,
// paces a tile (on the H100, more masked tiles slowed the kernel more than
// the products they added), so only tiles where the causal diagonal, the
// window's edge, a segment boundary or a ragged end falls take the mask, and
// there it is one range of visible columns a row, two integer compares an
// element. A warpgroup skips the products of a tile its rows cannot see.
// The heaviest causal q tiles are launched first, and the query heads of one
// kv head are neighbours in launch order, so their K/V tiles meet in L2.
//
// Per head_dim (Config, and sm90.cuh's Panels for the tile layout):
// - D=64 and 128: 128 rows a block, 64 a warpgroup, a 4-stage ring (64 + 4 x
//   32 KB at D=128, one block per SM), each tile issued two tiles ahead of
//   its use. Within a warpgroup tile j's S and dP and tile j-1's dQ product
//   are in flight together, and the elementwise dS of tile j runs while the
//   dQ product finishes. dQ is 32 or 64 registers a thread.
// - D=80 and 96 (Phi-2, GPT-NeoX) are not a whole number of 128-byte
//   swizzle atoms: every tile is a 64-column panel under the 128-byte
//   swizzle and a tail panel of 16 or 32 columns under the 32- or 64-byte
//   swizzle, with a TMA box of its own. S and dP take D/16 k-steps, the last
//   from the tail; dQ += dS.K is an n64 product over the panel and an n16 or
//   n32 product over the tail a k-slice, reading K's rows (64 keys) MN-major
//   as dK/dV reads Q's. dQ covers D columns, never 128: 40 or 48 registers a
//   thread. The layout and pipeline are D=128's: 40 + 4 x 20 = 120 KB and
//   48 + 4 x 24 = 144 KB of shared memory.
// - D=256 (GPT-J, Gemma2): 128 rows would need Q and dO (128 KB) and two
//   64-key K/V stages (128 KB), over the 227 KB a block may have, and dQ of
//   a full row would be 128 registers beside S, dP and dS. A block owns 64
//   rows and the two warpgroups split D: warpgroup w holds columns
//   128w..128w+127 of dQ (64 registers), and both need dS of all 64 keys. So
//   warpgroup 0 computes S and warpgroup 1 dP (the same products once);
//   through 16 KB of shared memory each hands its partner the half of its
//   tile the partner's 32 keys need, each computes dS of its 32 keys, and
//   the packed halves are swapped back as A fragments. Thread i of one
//   warpgroup trades only with thread i of the other, a __syncthreads
//   between writes and reads. A 2-stage ring, each tile issued one ahead:
//   32 + 32 + 2 x 64 + 16 KB. 64-row blocks would read every K/V band twice
//   as often as 128-row ones, from device memory where K and V outgrow L2
//   (GPT-J's 128 MB), so the grid launches the q tiles of one (batch, head)
//   in groups of four side by side (kGroup), heaviest group first: the four
//   walk the same K/V tiles together and share them in L2.
//
// Registers, and why there is no producer warp: a thread holds dQ (up to 64
// f32), S and dP (32 each) and dS packed (16). As in the other wgmma
// kernels, a ninth warp would cap every thread at 168 registers at compile
// time (four 16K register partitions an SM); eight warps may use 255, and
// ptxas reports no spill at any D.
//
// Tried on the H100 (80GB HBM3, 700 W) and not kept, each no faster or
// slower: a persistent grid (the ring running on across work items, Q/dO
// double-buffered, 3 stages), a 3- or 5-stage ring, Q and dO as register A
// fragments, each warpgroup taking two 32-row quarters so both see the
// diagonal, S/dP of the next tile double-buffered in registers (255
// registers, spills, wgmma serialised), and S, dP and dQ in three commit
// groups. At D=256: 128 rows a block with 32-key K/V tiles (n32 products
// for S and dP, two n128 products for dQ, a 3-stage ring in 224 KB, no
// spill), slower than the split 64-row blocks at GPT-J's and Gemma2-9B's
// shapes once those launch in groups; the split blocks launched one q tile
// at a time lost to it at GPT-J's shape (K/V read from device memory once
// per 64 rows), and groups of two gained a little less than groups of four.
// Left for later: a TMA store of dQ; at D=256, the last tile's dQ product
// under the next tile's S and dP (the 2-stage ring then holds no tile
// ahead).

#include "sm90.cuh"

namespace {

using namespace sm90;

constexpr int kThreads = 256;  // two warpgroups
constexpr float kLog2e = 1.4426950408889634f;

struct Params {
  CUtensorMap tm_q;  // the 64-column panels
  CUtensorMap tm_k;
  CUtensorMap tm_v;
  CUtensorMap tm_do;
  const float* lse;    // [B, H, Sq]
  const float* delta;  // [B, H, Sq]
  const int* seg;      // [B, S] segment ids, or null
  void* dq;
  int H, G, Sq, Sk;
  float sm_scale;
  float softcap;  // <= 0: none
  int causal;
  int window;     // <= 0: none
  CUtensorMap tm_q_tail, tm_k_tail, tm_v_tail, tm_do_tail;  // at D = 80 or 96, the tail panel
};

// Tiles and shared memory per head_dim, every tile 1024-byte aligned: Q and
// dO [kBlockM rows x D], K[stage] and V[stage] [64 keys x D], each in
// Panels<D> order, at D=256 the warpgroups' exchange [2][16][128] words,
// then the barriers. At D=128 that is 197,704 bytes with the alignment slack.
template <int D>
struct Config {
  static constexpr bool kSplit = D > 128;           // the warpgroups share the rows, split D
  static constexpr int kBlockM = kSplit ? 64 : 128;  // query rows a block
  static constexpr int kBlockN = 64;                 // keys a K/V tile
  static constexpr int kStages = kSplit ? 2 : 4;     // K/V ring depth
  static constexpr int kGroup = kSplit ? 4 : 1;      // q tiles of one head launched side by side
  static constexpr int kCols = kSplit ? D / 2 : D;   // dQ columns a warpgroup holds
  static constexpr int kQ = kBlockM * D * 2;
  static constexpr int kKV = kBlockN * D * 2;
  static constexpr int kQs = 0;
  static constexpr int kDo = kQ;
  static constexpr int kK = 2 * kQ;
  static constexpr int kV = kK + kStages * kKV;
  static constexpr int kX = kV + kStages * kKV;
  static constexpr int kBar = kX + (kSplit ? 2 * 16 * 128 * 4 : 0);
  static constexpr int kBytes = kBar + (1 + 2 * kStages) * 8;
  static constexpr int kAlloc = kBytes + 1024;
  static_assert(kAlloc <= 232448, "more shared memory than a block may have");
};

// The thread's two rows, row0 and row0 + 8, read once before the loop: lse
// in log2 units less log2|sm_scale| (so exp2 gives P * |sm_scale|), the sign
// of sm_scale and -sign * delta, and the segment ids.
struct Rows {
  float lse0, lse1;
  float sign, nd0, nd1;
  int row0;
  int seg0, seg1;
  const int* kseg;  // the batch's segment ids (device memory), or null
};

// dS of 2N keys from k0 (N entries a thread), in place of dP: P = exp(s -
// lse) on visible pairs (0 on masked ones), dS = P * sm_scale * chain * (dP
// - delta), with sm_scale folded into the exponent. Entry j is key k0 + 2t +
// c(j), c(j) = 8 * (j / 4) + (j & 1); entries j % 4 < 2 are row row0, the
// others row0 + 8. The mask keeps c(j) in a per-row range [lo, hi] (causal,
// window, ragged ends), and equal segment ids.
template <bool kMask, bool kCap, int N>
__device__ __forceinline__ void tile_ds(const float (&s)[N], float (&dp)[N], const Params& p,
                                        const Rows& r, int k0, int t) {
  const float scale2 = p.sm_scale * kLog2e;
  int lo[2] = {0, 0}, hi[2] = {0, 0};
  if constexpr (kMask) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int row = r.row0 + 8 * e;
      int last = p.causal ? min(p.Sk - 1, row) : p.Sk - 1;
      if (row >= p.Sq) last = -1;
      const int first = p.window > 0 ? row - p.window + 1 : 0;
      lo[e] = first - k0 - 2 * t;
      hi[e] = last - k0 - 2 * t;
    }
  }
#pragma unroll
  for (int j = 0; j < N; ++j) {
    const int e = (j >> 1) & 1;
    float x2, chain = 1.f;
    if constexpr (kCap) {
      const float xc = p.softcap * tanhf(s[j] * p.sm_scale / p.softcap);  // pre-mask s_cap
      const float u = xc / p.softcap;
      chain = 1.f - u * u;
      x2 = xc * kLog2e;
    } else {
      x2 = s[j] * scale2;
    }
    float prob = fast_exp2(x2 - (e ? r.lse1 : r.lse0));
    if constexpr (kMask) {
      const int c = 8 * (j >> 2) + (j & 1);
      bool keep = c >= lo[e] && c <= hi[e];
      if (r.kseg != nullptr) keep = keep && r.kseg[k0 + 2 * t + c] == (e ? r.seg1 : r.seg0);
      if (!keep) prob = 0.f;
    }
    const float g = fmaf(r.sign, dp[j], e ? r.nd1 : r.nd0);  // sign * (dP - delta)
    if constexpr (kCap) {
      dp[j] = prob * chain * g;
    } else {
      dp[j] = prob * g;
    }
  }
}

template <int N>
__device__ __forceinline__ void ds_of(const float (&s)[N], float (&dp)[N], const Params& p,
                                      const Rows& r, int k0, int t, bool mask) {
  if (p.softcap > 0.f) {
    if (mask) tile_ds<true, true>(s, dp, p, r, k0, t);
    else tile_ds<false, true>(s, dp, p, r, k0, t);
  } else {
    if (mask) tile_ds<true, false>(s, dp, p, r, k0, t);
    else tile_ds<false, false>(s, dp, p, r, k0, t);
  }
}

// Two D-wide tiles of `rows` rows into a and b on one barrier, panel by
// panel (a's, then b's), the tails last.
template <int D>
__device__ __forceinline__ void tma_load_pair(uint8_t* a, const CUtensorMap* a_map,
                                              const CUtensorMap* a_tail, uint8_t* b,
                                              const CUtensorMap* b_map, const CUtensorMap* b_tail,
                                              uint64_t* bar, int rows, int c1, int c2, int c3) {
  using P = Panels<D>;
#pragma unroll
  for (int x = 0; x < P::kFull; ++x) {
    tma_load_4d(a + x * rows * 128, a_map, bar, 64 * x, c1, c2, c3);
    tma_load_4d(b + x * rows * 128, b_map, bar, 64 * x, c1, c2, c3);
  }
  if constexpr (P::kTail > 0) {
    tma_load_4d(a + P::kFull * rows * 128, a_tail, bar, 64 * P::kFull, c1, c2, c3);
    tma_load_4d(b + P::kFull * rows * 128, b_tail, bar, 64 * P::kFull, c1, c2, c3);
  }
}

// Thread 0 issues K/V tile `it` of the band into its stage once both
// warpgroups have released the tile that held it.
template <int D>
__device__ __forceinline__ void issue_tile(const Params& p, uint8_t* smem, uint64_t* full,
                                           uint64_t* empty, int it, int kt_lo, int kvh, int b) {
  using C = Config<D>;
  const int s = it % C::kStages;
  const int k0 = (kt_lo + it) * C::kBlockN;
  mbar_wait(&empty[s], ((it / C::kStages) & 1) ^ 1);
  mbar_arrive_expect_tx(&full[s], 2 * C::kKV);
  tma_load_pair<D>(smem + C::kK + s * C::kKV, &p.tm_k, &p.tm_k_tail, smem + C::kV + s * C::kKV,
                   &p.tm_v, &p.tm_v_tail, &full[s], C::kBlockN, kvh, k0, b);
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads, 1)
    flash_bwd_dq_sm90_kernel(const __grid_constant__ Params p) {
  using C = Config<D>;
  constexpr bool kSplit = C::kSplit;
  constexpr int kM = C::kBlockM;
  constexpr int kN = C::kBlockN;
  // Tiles issued ahead of use: the ring also holds the tile in S/dP and,
  // without kSplit, the one whose dQ product is in flight.
  constexpr int kLead = kSplit ? 1 : C::kStages - 2;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = aligned_smem(smem_raw);
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + C::kBar);
  uint64_t* q_full = bars;
  uint64_t* full = bars + 1;
  uint64_t* empty = bars + 1 + C::kStages;

  // Block (x, b, z) is head x / kGroup's q tile kGroup * z + x % kGroup,
  // counted from the last: the longest causal rows start first, and the rep
  // heads of one kv head are neighbours.
  int h = blockIdx.x;
  const int b = blockIdx.y;
  int q0 = (gridDim.z - 1 - blockIdx.z) * kM;
  if constexpr (C::kGroup > 1) {
    const int qt = (p.Sq + kM - 1) / kM - 1 - (int)(C::kGroup * blockIdx.z + h % C::kGroup);
    if (qt < 0) return;  // a last group that q tile 0 does not fill
    h /= C::kGroup;
    q0 = qt * kM;
  }
  const int kvh = h / (p.H / p.G);
  const int wg = warpgroup_index();
  const int lane = threadIdx.x % 32;

  // The band of key tiles (flash_pallas._k_band / _block_visible).
  const int nk = (p.Sk + kN - 1) / kN;
  int kt_lo = 0, kt_hi = nk;
  if (p.causal) kt_hi = min(nk, (q0 + kM - 1) / kN + 1);
  if (p.window > 0) kt_lo = max(0, q0 - p.window + 1) / kN;
  const int n_tiles = max(0, kt_hi - kt_lo);

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < C::kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 8);  // every warp
    }
    fence_barrier_init();
    mbar_arrive_expect_tx(q_full, 2 * C::kQ);
    tma_load_pair<D>(smem + C::kQs, &p.tm_q, &p.tm_q_tail, smem + C::kDo, &p.tm_do,
                     &p.tm_do_tail, q_full, kM, h, q0, b);
    for (int it = 0; it < min(kLead, n_tiles); ++it) {
      issue_tile<D>(p, smem, full, empty, it, kt_lo, kvh, b);
    }
  }
  __syncthreads();

  const int t = lane % 4;
  const int row_lo = q0 + (kSplit ? 0 : wg * 64);  // this warpgroup's rows
  const int row_hi = row_lo + 63;
  Rows r;
  r.row0 = row_lo + warp_in_warpgroup() * 16 + lane / 4;
  const int row1 = r.row0 + 8;
  const size_t row_off = ((size_t)b * p.H + h) * p.Sq;
  const float log2_scale = log2f(fabsf(p.sm_scale));
  r.sign = p.sm_scale < 0.f ? -1.f : 1.f;
  r.lse0 = (r.row0 < p.Sq ? p.lse[row_off + r.row0] * kLog2e : 0.f) - log2_scale;
  r.lse1 = (row1 < p.Sq ? p.lse[row_off + row1] * kLog2e : 0.f) - log2_scale;
  r.nd0 = -r.sign * (r.row0 < p.Sq ? p.delta[row_off + r.row0] : 0.f);
  r.nd1 = -r.sign * (row1 < p.Sq ? p.delta[row_off + row1] : 0.f);
  r.kseg = p.seg == nullptr ? nullptr : p.seg + (size_t)b * p.Sk;
  r.seg0 = r.seg1 = 0;
  if (p.seg != nullptr) {
    r.seg0 = r.row0 < p.Sq ? p.seg[(size_t)b * p.Sq + r.row0] : 0;
    r.seg1 = row1 < p.Sq ? p.seg[(size_t)b * p.Sq + row1] : 0;
  }

  float dq[C::kCols / 2];
#pragma unroll
  for (int j = 0; j < C::kCols / 2; ++j) dq[j] = 0.f;

  auto k_tile = [&](int it) { return smem + C::kK + (it % C::kStages) * C::kKV; };
  auto v_tile = [&](int it) { return smem + C::kV + (it % C::kStages) * C::kKV; };
  auto release = [&](int it) {
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[it % C::kStages]);
  };

  mbar_wait(q_full, 0);
  if constexpr (!kSplit) {
    float s[kN / 2], dp[kN / 2];
    uint32_t da[kN / 16][4];  // dS of the tile whose dQ product is next, as A fragments
    const KDesc q_desc = kmajor_descs<D>(smem + C::kQs, kM, wg * 64);  // this warpgroup's rows
    const KDesc do_desc = kmajor_descs<D>(smem + C::kDo, kM, wg * 64);
    // dQ += dS K of the tile whose dS is in da; committed, not waited for.
    auto issue_dq = [&](const KDesc& k_mn) {
#pragma unroll
      for (int kk = 0; kk < kN / 16; ++kk) {
        if constexpr (D % 64 == 0) {
          wgmma_rs<T, D>(dq, da[kk], k_mn.main + mnmajor_step(kk), 1);
        } else {
          wgmma_rs_d<T, D>(dq, da[kk], k_mn, kk, kN);
        }
      }
      wgmma_commit();
    };
    // The products read only registers written before their wgmma.fence:
    // descriptors are made first, and the barrier waits write none of them.
    int pending = -1;  // the tile whose dQ product is still to issue (its dS in da), or -1
    for (int it = 0; it < n_tiles; ++it) {
      if (threadIdx.x == 0 && it + kLead < n_tiles) {
        issue_tile<D>(p, smem, full, empty, it + kLead, kt_lo, kvh, b);
      }
      const int k0 = (kt_lo + it) * kN;
      const KDesc k_desc = kmajor_descs<D>(k_tile(it), kN);
      const KDesc v_desc = kmajor_descs<D>(v_tile(it), kN);
      const KDesc prev_mn = mnmajor_descs<D>(k_tile(max(pending, 0)), kN);
      mbar_wait(&full[it % C::kStages], (it / C::kStages) & 1);
      // visible and mask are written out where they are used: as lambdas,
      // ptxas kept their results as bytes and tested them every tile, 1-2 %
      // of the D=64/128 kernel's time on the H100.
      const bool visible = (!p.causal || k0 <= row_hi) &&
                           (p.window <= 0 || k0 + kN - 1 > row_lo - p.window);
      if (visible) {
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk) {  // S = Q K^T
          wgmma_ss<T, kN>(s, kmajor_slice<D>(q_desc, kk, kM), kmajor_slice<D>(k_desc, kk, kN),
                          kk > 0);
        }
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk) {  // dP = dO V^T
          wgmma_ss<T, kN>(dp, kmajor_slice<D>(do_desc, kk, kM), kmajor_slice<D>(v_desc, kk, kN),
                          kk > 0);
        }
        wgmma_commit();
        if (pending >= 0) {
          issue_dq(prev_mn);  // the last tile's dQ product runs under this tile's dS
          wgmma_wait<1>();
        } else {
          wgmma_wait<0>();
        }
        fence_regs(s);
        fence_regs(dp);
        const bool mask = (p.causal && k0 + kN - 1 > row_lo) ||
                          (p.window > 0 && k0 < row_hi - p.window + 1) || k0 + kN > p.Sk ||
                          row_hi >= p.Sq || p.seg != nullptr;
        ds_of(s, dp, p, r, k0, t, mask);
        if (pending >= 0) {
          wgmma_wait<0>();
          fence_regs(dq);
          release(pending);
        }
#pragma unroll
        for (int kk = 0; kk < kN / 16; ++kk) pack_a<T, kN / 2>(da[kk], dp, kk);
        pending = it;
      } else {
        if (pending >= 0) {
          wgmma_fence();
          issue_dq(prev_mn);
          wgmma_wait<0>();
          fence_regs(dq);
          release(pending);
          pending = -1;
        }
        release(it);
      }
    }
    if (pending >= 0) {
      const KDesc k_mn = mnmajor_descs<D>(k_tile(pending), kN);
      wgmma_fence();
      issue_dq(k_mn);
      wgmma_wait<0>();
      fence_regs(dq);
      release(pending);
    }
  } else {
    // Warpgroup 0 computes S = Q K^T, warpgroup 1 dP = dO V^T, each over
    // all 64 rows and keys; through shared memory each hands its partner
    // (thread i of the other warpgroup, which holds the same rows) the half
    // of its tile the partner's 32 keys need, each computes dS of its 32
    // keys, and the packed halves are swapped back: both then hold dS of all
    // 64 keys as A fragments for their own 128 columns of dQ.
    float* x = reinterpret_cast<float*>(smem + C::kX);
    uint32_t* xw = reinterpret_cast<uint32_t*>(x);
    const int tid = threadIdx.x % 128;
    const KDesc a_desc = kmajor_descs<D>(smem + (wg == 0 ? C::kQs : C::kDo), kM);
    for (int it = 0; it < n_tiles; ++it) {
      if (threadIdx.x == 0 && it + kLead < n_tiles) {
        issue_tile<D>(p, smem, full, empty, it + kLead, kt_lo, kvh, b);
      }
      const int k0 = (kt_lo + it) * kN;
      const KDesc b_desc = kmajor_descs<D>(wg == 0 ? k_tile(it) : v_tile(it), kN);
      const uint64_t k_mn = desc_sw128(k_tile(it) + 2 * wg * kN * 128, kN * 128, 1024);
      mbar_wait(&full[it % C::kStages], (it / C::kStages) & 1);
      // The same for both warpgroups: both trade or neither does.
      const bool visible = (!p.causal || k0 <= row_hi) &&
                           (p.window <= 0 || k0 + kN - 1 > row_lo - p.window);
      if (visible) {
        float acc[32];
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk) {
          wgmma_ss<T, 64>(acc, kmajor_slice<D>(a_desc, kk, kM), kmajor_slice<D>(b_desc, kk, kN),
                          kk > 0);
        }
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(acc);
        // Entries 0-15 are keys k0..k0+31, entries 16-31 the next 32.
        // Warpgroup w keeps its product on keys 32w.. and hands the other
        // half over: round 1 writes x[w], reads x[1 - w]; round 2 writes
        // x[1 - w], reads x[w].
        float keep[16];
#pragma unroll
        for (int j = 0; j < 16; ++j) {
          keep[j] = wg == 0 ? acc[j] : acc[16 + j];
          x[(wg * 16 + j) * 128 + tid] = wg == 0 ? acc[16 + j] : acc[j];
        }
        __syncthreads();
        float s[16], dp[16];
#pragma unroll
        for (int j = 0; j < 16; ++j) {
          const float got = x[((1 - wg) * 16 + j) * 128 + tid];
          s[j] = wg == 0 ? keep[j] : got;
          dp[j] = wg == 0 ? got : keep[j];
        }
        const int kw0 = k0 + 32 * wg;  // this warpgroup's keys
        const bool mask = (p.causal && kw0 + 31 > row_lo) ||
                          (p.window > 0 && kw0 < row_hi - p.window + 1) || kw0 + 32 > p.Sk ||
                          row_hi >= p.Sq || p.seg != nullptr;
        ds_of(s, dp, p, r, kw0, t, mask);
        uint32_t half[2][4];  // dS of this warpgroup's 32 keys
        pack_a<T, 16>(half[0], dp, 0);
        pack_a<T, 16>(half[1], dp, 1);
#pragma unroll
        for (int i = 0; i < 8; ++i) xw[((1 - wg) * 16 + i) * 128 + tid] = half[i / 4][i % 4];
        __syncthreads();
        uint32_t da[4][4];  // k16 slices 0-1 from warpgroup 0, 2-3 from 1
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const uint32_t got = xw[(wg * 16 + i) * 128 + tid];
          da[i / 4][i % 4] = wg == 0 ? half[i / 4][i % 4] : got;
          da[2 + i / 4][i % 4] = wg == 0 ? got : half[i / 4][i % 4];
        }
        // dQ += dS K over this warpgroup's columns: panels 2w and 2w + 1.
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < kN / 16; ++kk) {
          wgmma_rs<T, C::kCols>(dq, da[kk], k_mn + mnmajor_step(kk), 1);
        }
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(dq);
      }
      release(it);
    }
  }

  const size_t q_stride = (size_t)p.H * D;
  const int col0 = kSplit ? wg * C::kCols : 0;  // this warpgroup's first column
  T* dqg = static_cast<T*>(p.dq) + (size_t)b * p.Sq * q_stride + (size_t)h * D + col0;
#pragma unroll
  for (int n = 0; n < C::kCols / 8; ++n) {
    const int col = 8 * n + 2 * t;
    if (r.row0 < p.Sq) store2<T>(dqg + (size_t)r.row0 * q_stride + col, dq[4 * n], dq[4 * n + 1]);
    if (row1 < p.Sq) store2<T>(dqg + (size_t)row1 * q_stride + col, dq[4 * n + 2], dq[4 * n + 3]);
  }
}

// The tensor maps of one call at head_dim D, then the kernel of (T, D).
template <int D>
int launch(Params p, const void* q, const void* k, const void* v, const void* dout, int dtype,
           int B, cudaStream_t stream) {
  using C = Config<D>;
  int err = make_maps_bshd<D>(&p.tm_q, &p.tm_q_tail, q, dtype, B, p.Sq, p.H, C::kBlockM);
  if (err == 0) {
    err = make_maps_bshd<D>(&p.tm_do, &p.tm_do_tail, dout, dtype, B, p.Sq, p.H, C::kBlockM);
  }
  if (err == 0) err = make_maps_bshd<D>(&p.tm_k, &p.tm_k_tail, k, dtype, B, p.Sk, p.G, C::kBlockN);
  if (err == 0) err = make_maps_bshd<D>(&p.tm_v, &p.tm_v_tail, v, dtype, B, p.Sk, p.G, C::kBlockN);
  if (err != 0) return err;
  auto kernel = dtype == 1 ? flash_bwd_dq_sm90_kernel<__nv_bfloat16, D>
                           : flash_bwd_dq_sm90_kernel<__half, D>;
  const cudaError_t set =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, C::kAlloc);
  if (set != cudaSuccess) return (int)set;
  const int nq = (p.Sq + C::kBlockM - 1) / C::kBlockM;
  const dim3 grid(C::kGroup * p.H, B, (nq + C::kGroup - 1) / C::kGroup);
  kernel<<<grid, kThreads, C::kAlloc, stream>>>(p);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 1 = bfloat16, 2 = float16; D is 64, 80, 96, 128 or 256, and any
// other D is refused. The caller has checked shapes, types, contiguity and
// 16-byte alignment. Returns 0, a cudaError_t, or a tensor-map encoding
// failure (flash_bwd_dq_sm90_error_string says which).
extern "C" int flash_bwd_dq_sm90(const void* q, const void* k, const void* v, const void* dout,
                                 const float* lse, const float* delta, const int* seg, void* dq,
                                 int dtype, int B, int H, int G, int Sq, int Sk, int D,
                                 float sm_scale, float softcap, int causal, int window,
                                 void* stream) {
  if ((dtype != 1 && dtype != 2) || Sk <= 0) return (int)cudaErrorInvalidValue;
  if (D != 64 && D != 80 && D != 96 && D != 128 && D != 256) return (int)cudaErrorInvalidValue;
  if (B == 0 || Sq == 0) return 0;
  Params p{};
  p.lse = lse;
  p.delta = delta;
  p.seg = seg;
  p.dq = dq;
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

extern "C" const char* flash_bwd_dq_sm90_error_string(int code) { return error_string(code); }
