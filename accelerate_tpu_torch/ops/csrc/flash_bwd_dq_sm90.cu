// Flash-attention dQ backward kernel for Hopper (sm_90a) on wgmma and TMA,
// written by hand: the route of 16-bit inputs at head_dim 64 and 128
// (flash_cuda._wgmma_route("dq", ...)). float32 inputs and every other
// head_dim (80, 96 and 256 among them, until this kernel takes them) take
// flash_bwd.cu's flash_bwd_dq_kernel, whichever route the call's dK/dV
// kernel takes (flash_bwd_dkdv_sm90.cu also takes 80, 96 and 256).
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
// What bounds it: three products per visible (q, k) pair, 6 * D operations.
// At the training shape (B=8, S=1024, H=16, G=8, D=128, causal, bf16) that
// is 5.16e10 operations over ~135 MB, at the Llama-3-8B main-path shape (B=4,
// S=2048, H=32, G=8) 2.06e11 over ~237 MB: the tensor-core rate bounds it
// (0.052 and 0.209 ms at 989 TFLOP/s).
//
// Design. A block owns 128 query rows of one (batch, head): two warpgroups of
// 64 rows, 256 threads. Thread 0 loads Q and dO once by TMA and streams K and
// V in 64-key tiles through a 4-stage ring (64 + 4 x 32 KB at D=128, one
// block per SM) under a full and an empty mbarrier per stage, each tile
// issued two tiles ahead of its use. lse and delta of the thread's two rows
// are read into registers before the loop, sm_scale folded into lse as
// -log2|sm_scale|. S = Q.K^T and dP = dO.V^T are
// wgmma m64n64k16 chains with both operands K-major in shared memory; dS is
// computed in registers and, rounded to the input type, is the register A
// operand of dQ += dS.K (wgmma m64nDk16), which reads the same K tile through
// an MN-major descriptor. Within a warpgroup tile j's S and dP and tile j-1's
// dQ product are in flight together, and the elementwise dS of tile j runs
// while the dQ product finishes. dQ accumulates in f32 registers (64 a thread
// at D=128) and each row is written once by one thread: no atomics, so
// repeat launches are bit-identical. The elementwise dS, more than the
// products, paces a tile (on the H100, more masked tiles slowed the kernel
// more than the products they added), so only tiles where the causal
// diagonal, the window's edge, a segment boundary or a ragged end falls
// take the mask, and there it is one range of visible columns a row, two
// integer compares an element. A warpgroup skips the products of a tile its
// rows cannot see.
// The heaviest causal q tiles are launched first, and the query heads of one
// kv head are neighbours in launch order, so their K/V tiles meet in L2.
//
// Registers, and why there is no producer warp: a thread holds dQ (64 f32 at
// D=128), S and dP (32 each) and dS packed (16). As in the other wgmma
// kernels, a ninth warp would cap every thread at 168 registers at compile
// time (four 16K register partitions an SM); eight warps may use 255.
//
// Tried on the H100 and not kept, each no faster or slower: a persistent
// grid (the ring running on across work items, Q/dO double-buffered, 3
// stages), a 3- or 5-stage ring, Q and dO as register A fragments, each
// warpgroup taking two 32-row quarters so both see the diagonal, S/dP of
// the next tile double-buffered in registers (255 registers, spills, wgmma
// serialised), and S, dP and dQ in three commit groups. Left for later: a
// TMA store of dQ.

#include "sm90.cuh"

namespace {

using namespace sm90;

constexpr int kBlockM = 128;   // query rows per block: two warpgroups x 64
constexpr int kBlockN = 64;    // keys per K/V tile
constexpr int kStages = 4;     // K/V ring: the tile in dQ, the tile in S/dP, two loading
constexpr int kThreads = 256;  // two warpgroups
constexpr float kLog2e = 1.4426950408889634f;

struct Params {
  CUtensorMap tm_q;
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
};

// Shared memory, every tile 1024-byte aligned: Q and dO [boxes][128 rows][64],
// K[stage] and V[stage] [boxes][64 keys][64], then the barriers. At D=128
// that is 197,704 bytes with the alignment slack.
template <int D>
struct Layout {
  static constexpr int kQ = kBlockM * D * 2;
  static constexpr int kKV = kBlockN * D * 2;
  static constexpr int kQs = 0;
  static constexpr int kDo = kQ;
  static constexpr int kK = 2 * kQ;
  static constexpr int kV = kK + kStages * kKV;
  static constexpr int kBar = kV + kStages * kKV;
  static constexpr int kBytes = kBar + (1 + 2 * kStages) * 8;
  static constexpr int kAlloc = kBytes + 1024;
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

// dS of one tile, in place of dP: P = exp(s - lse) on visible pairs (0 on
// masked ones), dS = P * sm_scale * chain * (dP - delta), with sm_scale
// folded into the exponent. Column j of S is key k0 + 2t + c(j), c(j) = 8 *
// (j / 4) + (j & 1); entries j % 4 < 2 are row row0, the others row0 + 8.
// The mask keeps c(j) in a per-row range [lo, hi] (causal, window, ragged
// ends), and equal segment ids.
template <bool kMask, bool kCap>
__device__ __forceinline__ void tile_ds(const float (&s)[32], float (&dp)[32], const Params& p,
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
  for (int j = 0; j < 32; ++j) {
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

// Thread 0 issues K/V tile `it` of the band into its stage once both
// warpgroups have released the tile that held it.
template <int D>
__device__ __forceinline__ void issue_tile(const Params& p, uint8_t* smem, uint64_t* full,
                                           uint64_t* empty, int it, int kt_lo, int kvh, int b) {
  using L = Layout<D>;
  const int s = it % kStages;
  const int k0 = (kt_lo + it) * kBlockN;
  mbar_wait(&empty[s], ((it / kStages) & 1) ^ 1);
  mbar_arrive_expect_tx(&full[s], 2 * L::kKV);
  for (int x = 0; x < D / 64; ++x) {
    tma_load_4d(smem + L::kK + s * L::kKV + x * kBlockN * 128, &p.tm_k, &full[s], 64 * x, kvh,
                k0, b);
    tma_load_4d(smem + L::kV + s * L::kKV + x * kBlockN * 128, &p.tm_v, &full[s], 64 * x, kvh,
                k0, b);
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads, 1)
    flash_bwd_dq_sm90_kernel(const __grid_constant__ Params p) {
  using L = Layout<D>;
  constexpr int kBoxes = D / 64;
  constexpr int kLead = kStages - 2;  // tiles issued ahead of use
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = aligned_smem(smem_raw);
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + L::kBar);
  uint64_t* q_full = bars;
  uint64_t* full = bars + 1;
  uint64_t* empty = bars + 1 + kStages;

  const int h = blockIdx.x;  // the rep heads of one kv head are neighbours
  const int b = blockIdx.y;
  const int q0 = (gridDim.z - 1 - blockIdx.z) * kBlockM;  // the longest causal rows start first
  const int kvh = h / (p.H / p.G);
  const int wg = warpgroup_index();
  const int lane = threadIdx.x % 32;

  // The band of key tiles (flash_pallas._k_band / _block_visible).
  const int nk = (p.Sk + kBlockN - 1) / kBlockN;
  int kt_lo = 0, kt_hi = nk;
  if (p.causal) kt_hi = min(nk, (q0 + kBlockM - 1) / kBlockN + 1);
  if (p.window > 0) kt_lo = max(0, q0 - p.window + 1) / kBlockN;
  const int n_tiles = max(0, kt_hi - kt_lo);

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 8);  // every warp
    }
    fence_barrier_init();
    mbar_arrive_expect_tx(q_full, 2 * L::kQ);
    for (int x = 0; x < kBoxes; ++x) {
      tma_load_4d(smem + L::kQs + x * kBlockM * 128, &p.tm_q, q_full, 64 * x, h, q0, b);
      tma_load_4d(smem + L::kDo + x * kBlockM * 128, &p.tm_do, q_full, 64 * x, h, q0, b);
    }
    for (int it = 0; it < min(kLead, n_tiles); ++it) {
      issue_tile<D>(p, smem, full, empty, it, kt_lo, kvh, b);
    }
  }
  __syncthreads();

  const int t = lane % 4;
  const int row_lo = q0 + wg * 64;
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

  float dq[D / 2];
#pragma unroll
  for (int j = 0; j < D / 2; ++j) dq[j] = 0.f;
  float s[32], dp[32];
  uint32_t da[4][4];  // dS of the tile whose dQ product is next, as A fragments
  const uint64_t q_desc = desc_sw128(smem + L::kQs + wg * 64 * 128, 16, 1024);  // this warpgroup's rows
  const uint64_t do_desc = desc_sw128(smem + L::kDo + wg * 64 * 128, 16, 1024);

  // The products read only registers written before their wgmma.fence:
  // descriptors are made first, and the barrier waits write none of them.
  auto k_tile = [&](int it) { return smem + L::kK + (it % kStages) * L::kKV; };
  auto v_tile = [&](int it) { return smem + L::kV + (it % kStages) * L::kKV; };
  // dQ += dS K of the tile whose dS is in da; committed, not waited for.
  auto issue_dq = [&](uint64_t k_mn) {
#pragma unroll
    for (int kk = 0; kk < kBlockN / 16; ++kk) {
      wgmma_rs<T, D>(dq, da[kk], k_mn + mnmajor_step(kk), 1);
    }
    wgmma_commit();
  };
  auto release = [&](int it) {
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[it % kStages]);
  };

  mbar_wait(q_full, 0);
  int pending = -1;  // the tile whose dQ product is still to issue (its dS in da), or -1
  for (int it = 0; it < n_tiles; ++it) {
    if (threadIdx.x == 0 && it + kLead < n_tiles) {
      issue_tile<D>(p, smem, full, empty, it + kLead, kt_lo, kvh, b);
    }
    const int k0 = (kt_lo + it) * kBlockN;
    const uint64_t k_desc = desc_sw128(k_tile(it), 16, 1024);
    const uint64_t v_desc = desc_sw128(v_tile(it), 16, 1024);
    const uint64_t prev_mn = desc_sw128(k_tile(max(pending, 0)), kBlockN * 128, 1024);
    mbar_wait(&full[it % kStages], (it / kStages) & 1);
    const bool visible = (!p.causal || k0 <= row_hi) &&
                         (p.window <= 0 || k0 + kBlockN - 1 > row_lo - p.window);
    if (visible) {
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {  // S = Q K^T
        wgmma_ss<T, 64>(s, q_desc + kmajor_step(kk, kBlockM), k_desc + kmajor_step(kk, kBlockN),
                        kk > 0);
      }
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {  // dP = dO V^T
        wgmma_ss<T, 64>(dp, do_desc + kmajor_step(kk, kBlockM),
                        v_desc + kmajor_step(kk, kBlockN), kk > 0);
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
      const bool mask = (p.causal && k0 + kBlockN - 1 > row_lo) ||
                        (p.window > 0 && k0 < row_hi - p.window + 1) || k0 + kBlockN > p.Sk ||
                        row_hi >= p.Sq || p.seg != nullptr;
      if (p.softcap > 0.f) {
        if (mask) tile_ds<true, true>(s, dp, p, r, k0, t);
        else tile_ds<false, true>(s, dp, p, r, k0, t);
      } else {
        if (mask) tile_ds<true, false>(s, dp, p, r, k0, t);
        else tile_ds<false, false>(s, dp, p, r, k0, t);
      }
      if (pending >= 0) {
        wgmma_wait<0>();
        fence_regs(dq);
        release(pending);
      }
#pragma unroll
      for (int kk = 0; kk < kBlockN / 16; ++kk) pack_a<T, 32>(da[kk], dp, kk);
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
    const uint64_t k_mn = desc_sw128(k_tile(pending), kBlockN * 128, 1024);
    wgmma_fence();
    issue_dq(k_mn);
    wgmma_wait<0>();
    fence_regs(dq);
    release(pending);
  }

  const size_t q_stride = (size_t)p.H * D;
  T* dqg = static_cast<T*>(p.dq) + (size_t)b * p.Sq * q_stride + (size_t)h * D;
#pragma unroll
  for (int n = 0; n < D / 8; ++n) {
    const int col = 8 * n + 2 * t;
    if (r.row0 < p.Sq) store2<T>(dqg + (size_t)r.row0 * q_stride + col, dq[4 * n], dq[4 * n + 1]);
    if (row1 < p.Sq) store2<T>(dqg + (size_t)row1 * q_stride + col, dq[4 * n + 2], dq[4 * n + 3]);
  }
}

template <typename T, int D>
int launch(const Params& p, int B, cudaStream_t stream) {
  using L = Layout<D>;
  const cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dq_sm90_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize, L::kAlloc);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(p.H, B, (p.Sq + kBlockM - 1) / kBlockM);
  flash_bwd_dq_sm90_kernel<T, D><<<grid, kThreads, L::kAlloc, stream>>>(p);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 1 = bfloat16, 2 = float16; D is 64 or 128, and any other D (80,
// 96 and 256 among them) is refused. The caller has checked
// shapes, types, contiguity and 16-byte alignment. Returns 0, a cudaError_t,
// or a tensor-map encoding failure (flash_bwd_dq_sm90_error_string says
// which).
extern "C" int flash_bwd_dq_sm90(const void* q, const void* k, const void* v, const void* dout,
                                 const float* lse, const float* delta, const int* seg, void* dq,
                                 int dtype, int B, int H, int G, int Sq, int Sk, int D,
                                 float sm_scale, float softcap, int causal, int window,
                                 void* stream) {
  if ((dtype != 1 && dtype != 2) || (D != 64 && D != 128) || Sk <= 0) {
    return (int)cudaErrorInvalidValue;
  }
  if (B == 0 || Sq == 0) return 0;
  Params p{};
  int err = make_map_bshd(&p.tm_q, q, dtype, B, Sq, H, D, kBlockM);
  if (err == 0) err = make_map_bshd(&p.tm_do, dout, dtype, B, Sq, H, D, kBlockM);
  if (err == 0) err = make_map_bshd(&p.tm_k, k, dtype, B, Sk, G, D, kBlockN);
  if (err == 0) err = make_map_bshd(&p.tm_v, v, dtype, B, Sk, G, D, kBlockN);
  if (err != 0) return err;
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
    case 64: return dtype == 1 ? launch<__nv_bfloat16, 64>(p, B, s) : launch<__half, 64>(p, B, s);
    case 128:
      return dtype == 1 ? launch<__nv_bfloat16, 128>(p, B, s) : launch<__half, 128>(p, B, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

extern "C" const char* flash_bwd_dq_sm90_error_string(int code) { return error_string(code); }
