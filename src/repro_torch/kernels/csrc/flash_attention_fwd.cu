// Causal / full GQA flash-attention forward for Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/flash_attention.py::_fwd_kernel
// (entry flash_attention_fwd). Same function: online-softmax attention with
// the G query heads that share one KV head folded into the rows of the q tile,
// KV tiles above the causal diagonal skipped, o in q's type and
// lse = m + log(l) in f32.
//
// What bounds it on this card: operations. At the serving shape
// (q (8,8,2048,4,64), k/v (8,8,2048,64), causal) the function needs
// 2*2*B*H*Sq*Skv*D/2 = 137 GFLOP against 67 MB of traffic, far above the
// card's ~295 FLOP/byte ridge, so the tensor cores are the limit. At D = 64
// the softmax's one exp2 an element comes as close: the SM's 16 exp2 a cycle
// take as long as its wgmma take for the two products of a 64-deep row, so
// the kernel nears the bound only where each hides the other.
//
// What the design does about it:
//   * both products are warpgroup wgmma.mma_async (f32 accumulate), the only
//     way to the tensor cores' full rate: s = q.k^T with both operands in
//     shared memory, o += p.v with p from registers (the f32 scores go
//     straight to a 16-bit A fragment) and V read MN-major;
//   * a block owns the folded q rows of a work item (q tile, kv head,
//     batch), 64 a consumer warpgroup: three warpgroups (192 rows) at D = 64,
//     and 112, so that while one runs its softmax two others keep the tensor
//     cores busy; two (128 rows) at D = 128 and 160, where o takes 64 and 80
//     registers a thread. One producer warp feeds them: the q tile, then K
//     and V tiles of 128 rows at D = 64 (64 at D = 112, 128 and 160) by TMA into a
//     ring of 3 buffers (2 at D = 160), K and V behind separate barriers. The consumers take the producer's
//     registers (setmaxnreg). q, o are read and written through a 5-D tensor
//     map (D, G, S, KVH, B) whose box is a tile of whole positions, so the
//     GQA fold stays a view; k, v through a 4-D map (D, S, KVH, B);
//   * D = 160 (stablelm-12b) is two and a half swizzle atoms: a row lies in
//     three 64-element column blocks whose last 32 columns are past the
//     tensor maps' extent of D, so TMA zero-fills them on a load and clips
//     them on the store of o, and never touches the next head's columns of a
//     GQA fold view. s = q.k^T takes 10 k16 steps, which stop at column 160;
//     o += p.v is one m64n160k16 wgmma, which reads two whole column blocks
//     of V and half of the third;
//   * D = 112 (zamba2-7b's shared attention block, 32 query heads over 32 KV
//     heads, G = 1) is one and three quarter swizzle atoms, laid out as 160
//     is: two column blocks a row, the last 16 columns of the second past the
//     maps' extent of D (zeros on a load, clipped on the store). s = q.k^T
//     takes 7 k16 steps; o += p.v is one m64n112k16 wgmma (N = 112 is a
//     multiple of 8), which reads the first column block of V whole and 48
//     columns of the second. What bounds it at zamba2's serving shape
//     (q (8,32,2048,1,112) causal) is operations again: 2*2*B*H*S^2*D/2 =
//     241 GFLOP against 0.47 GB. A consumer thread's accumulators take 104
//     registers (o 56, s 32, p 16), so three consumers fit in 160 each, as
//     at D = 64 (128 there): 192 folded rows a block, a ring of 3 stages of
//     64 KV rows, 192 KB of shared memory. Timed on an H100 against D =
//     128's tiles (two consumers, 0.766 ms), three took 0.640 ms; a ring of
//     4 (0.916) and KV tiles of 128 rows in a ring of 2 (0.829) were slower
//     (examples/profile_flash_fwd_torch.py, variants nc3_112, stages4,
//     kv128_112);
//   * the kernel is persistent: one block an SM walks over the work items,
//     heaviest first (item w is q tile n_tiles - 1 - w / (KVH B)), block i
//     taking items i, i + gridDim.x, ... The next item's q tile loads while
//     the last p.v of the current one runs, and o leaves through a tile of
//     its own by TMA (which also clips the ragged edge) while the next item
//     starts;
//   * each warpgroup issues s of tile j beside p.v of tile j - 1 and runs the
//     softmax of tile j while that product runs (the overlap within a
//     warpgroup of FlashAttention-3), and the warpgroups take turns, round
//     robin, to issue their products, so that one's softmax runs while the
//     others' products do. Both groups are waited for before the loop's back
//     edge: with wgmma groups in flight across it, ptxas serializes every
//     wgmma (its message C7515);
//   * the softmax costs few instructions: one ex2.approx.ftz an element with
//     scale and log2(e) folded into one FMA, and the mask test outside the
//     element loop (a tile that needs no mask runs a loop without one);
//   * causal sweeps end at the diagonal, and tiles a warpgroup would find
//     wholly masked are skipped.
//
// Differences from the TPU kernel, on purpose:
//   * the TPU grid's sequential KV axis is a loop inside one block, and m, l
//     are per-row registers, not lane-replicated (rows, 128) tiles;
//   * tiles are 128-192 folded rows x 64-128 kv positions (the TPU default of
//     512 x 512 with G = 4 is 2,048 accumulator rows, far beyond one SM);
//   * the ragged edges are masked, so any Sq, Skv >= 1 works; rows past the
//     whole positions of a tile read as 0 and are never stored;
//   * p is rounded to the input type for p.v (tensor-core operand); softmax
//     statistics stay f32.
// Kept from the TPU kernel: the finite mask value -1e30 and the guarded final
// divide max(l, 1e-30), so a fully masked row gives the same numbers, not NaN
// (lse = m * scale + log(l) with m the mask value itself).
//
// The tile plan (positions a tile, groups a tile, tiles along G when G exceeds
// the tile) is computed by the Python wrapper, which also checks what the
// tensor maps need: last dim contiguous, strides multiples of 16 bytes,
// 16-byte aligned storage.

#include "hopper.cuh"

namespace {

constexpr float NEG_INF = -1e30f;
constexpr int PRODUCER_REGS = 24;

// Consumer warpgroups a block, 64 folded q rows each: 3 at D = 64 and 112,
// where a consumer thread holds s (64 and 32 registers), p (32 and 16) and o
// (32 and 56) within 160; 2 at D = 128 and 160, where o alone takes 64 and 80.
template <int D>
__host__ __device__ constexpr int n_consumers() {
  return D == 64 || D == 112 ? 3 : 2;
}

// Depth of the ring of (K, V) tiles: 3, and 2 at D = 160, where a row takes
// three column blocks and three stages would not fit beside the q and o
// tiles in 227 KB (48 KB each, 24 KB a K or V tile).
template <int D>
__host__ __device__ constexpr int stages() {
  return D == 160 ? 2 : 3;
}

// Registers of a consumer thread after setmaxnreg: the SM's 64 K registers
// shared by NC x 128 consumer threads and 128 producer threads at 24.
template <int NC>
__host__ __device__ constexpr int consumer_regs() {
  return NC == 3 ? 160 : 240;
}

// KV rows of a swept tile: 128 at D = 64, 64 at D = 112, 128 and 160.
template <int D>
__host__ __device__ constexpr int kv_rows() {
  return D == 64 ? 128 : 64;
}

struct FwdParams {
  float* lse;  // (B,KVH,Sq,G) contiguous, written
  int B, KVH, Sq, Skv, G;
  TilePlan tp;
  int n_tiles;  // q tiles of one (batch, kv head)
  int causal, q_offset;
  float scale;
};

// Shared memory: the q tile and the o tile (QR rows each), STAGES x (K, V)
// tiles (kv_rows rows each), each row col_blocks<D> swizzled 128-byte
// blocks, then the barriers. Every tile starts on a 1024-byte boundary, as
// the 128-byte swizzle needs.
template <int D>
struct FwdSmem {
  static constexpr int NC = n_consumers<D>();
  static constexpr int STAGES = stages<D>();
  static constexpr int QR = 64 * NC;  // folded q rows a block owns
  static constexpr int QT = QR * col_blocks<D>() * ATOM;
  static constexpr int KV = kv_rows<D>() * col_blocks<D>() * ATOM;
  static constexpr int Q = 0, O = QT, STAGE = 2 * QT;
  // full_k[STAGES], full_v[STAGES], empty[STAGES], q_full, q_empty
  static constexpr int BAR = STAGE + STAGES * 2 * KV;
  static constexpr int BYTES = BAR + (3 * STAGES + 2) * 8;
  static constexpr int ALLOC = BYTES + 1024;  // room to align the base
  static_assert(ALLOC <= 232448, "more shared memory than a block may use");
};

// One work item: the q tile ``tile`` of (kv head h, batch b). Items are
// numbered heaviest first (the tile index falls slowest), and block i takes
// items i, i + gridDim.x, ...
struct Item {
  int h, b, pos0, g0, n_kt;
};

template <int NK>
__device__ __forceinline__ Item item_of(const FwdParams& p, int w) {
  const int hb = p.KVH * p.B;
  const int tile = p.n_tiles - 1 - w / hb;
  Item it;
  it.h = (w % hb) % p.KVH;
  it.b = (w % hb) / p.KVH;
  it.pos0 = (tile / p.tp.gchunks) * p.tp.P;
  it.g0 = (tile % p.tp.gchunks) * p.tp.Gt;
  // causal: KV tiles wholly above the diagonal of the q tile are never visited
  int kv_end = p.Skv;
  if (p.causal) kv_end = min(p.Skv, p.q_offset + min(it.pos0 + p.tp.P, p.Sq));
  it.n_kt = kv_end > 0 ? (kv_end + NK - 1) / NK : 0;
  return it;
}

// The row max in score units. A row that saw nothing but masked slots keeps
// the mask value itself, as in the TPU kernel, where the mask is applied
// after scaling.
__device__ __forceinline__ float scaled_max(float m_raw, float scale) {
  return m_raw == NEG_INF ? NEG_INF : m_raw * scale;
}

// Rows (i = 0: row g, 1: row g + 8) of this thread, as the online softmax
// carries them: the running max of the raw scores and the thread's part of
// the running sum.
struct RowStats {
  float m[2], l[2];
};

// p = exp(scale * (s - m_new)) of one tile in place, with the running
// statistics brought up to date; returns the factor (one a row) by which the
// output accumulated so far must be scaled. ``masked`` tiles set the scores
// of slots past kv_last (a row's last visible kv position) to the mask value
// first. Scores stay unscaled: scale and log2(e) are folded into the one FMA
// in front of ex2, so m is the max of the raw dots.
template <int NK>
__device__ __forceinline__ void softmax_tile(float (&s)[NK / 2], RowStats& st, float (&corr)[2], bool masked,
                                             int kv0, const int (&kv_last)[2], int t, float c2) {
  if (masked) {
#pragma unroll
    for (int j = 0; j < NK / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int kv = kv0 + 8 * j + 2 * t + (e & 1);
        s[4 * j + e] = kv <= kv_last[e >> 1] ? s[4 * j + e] : NEG_INF;
      }
    }
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    float mx = NEG_INF;
#pragma unroll
    for (int j = 0; j < NK / 8; ++j) mx = fmaxf(mx, fmaxf(s[4 * j + 2 * i], s[4 * j + 2 * i + 1]));
    const float mn = fmaxf(st.m[i], quad_max(mx));
    corr[i] = exp2_ftz((st.m[i] - mn) * c2);
    st.m[i] = mn;
    // A row with nothing visible so far (max still the mask value) takes
    // c = off = 0, so p = 1 on its masked slots as in the TPU kernel's
    // exp(s - m), instead of the difference of two huge products.
    const float c = mn == NEG_INF ? 0.f : c2;
    const float off = -mn * c;
    float sum = 0.f;
#pragma unroll
    for (int j = 0; j < NK / 8; ++j) {
      s[4 * j + 2 * i] = exp2_ftz(fmaf(s[4 * j + 2 * i], c, off));
      s[4 * j + 2 * i + 1] = exp2_ftz(fmaf(s[4 * j + 2 * i + 1], c, off));
      sum += s[4 * j + 2 * i] + s[4 * j + 2 * i + 1];
    }
    st.l[i] = st.l[i] * corr[i] + sum;
  }
}

// s = q.k^T of one KV tile (at ``sk``), 64 x NK for warpgroup ``wg`` of a q
// tile of QR rows, both operands K-major in shared memory; one wgmma group.
template <typename T, int D, int NK, int QR>
__device__ __forceinline__ void issue_s(float (&sacc)[NK / 2], uint32_t sq, uint32_t sk, int wg) {
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
    mma_ss<T, NK>(sacc, desc_k(sq, QR, 64 * wg, kk), desc_k(sk, NK, 0, kk), kk > 0);
  wgmma_commit();
}

// o += p.v of one KV tile (V at ``sv``, read MN-major), p from registers;
// issued as one wgmma group after a fence that no register write follows.
template <typename T, int D, int NK>
__device__ __forceinline__ void issue_pv(float (&o)[D / 2], const uint32_t (&pf)[NK / 16][4], uint32_t sv) {
  pin(o);
#pragma unroll
  for (int kk = 0; kk < NK / 16; ++kk) mma_rs<T, D>(o, pf[kk], desc_mn(sv, NK, kk));
  wgmma_commit();
}

// The o accumulator (64 x D of one warpgroup) times the row factors, rounded
// to T, into the 128-byte-swizzled tile ``tile`` (QR rows, col_blocks<D>
// column blocks) at rows [r0, r0 + 64): the layout TMA read q in and writes o
// from (the columns past D, where D = 160, are neither written nor stored).
// Row r's 16-byte chunk c lies at chunk c ^ (r % 8) of its 128-byte row.
template <typename T, int D, int QR>
__device__ __forceinline__ void o_to_smem(unsigned char* tile, int r0, const float (&o)[D / 2], const float (&f)[2],
                                          int wl, int g, int t) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = r0 + 16 * wl + g + 8 * i;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      const int cb = j / 8, c = j % 8;
      *reinterpret_cast<uint32_t*>(tile + cb * QR * ATOM + r * ATOM + ((c ^ (r & 7)) << 4) + 4 * t) =
          Mma<T>::pack(o[4 * j + 2 * i] * f[i], o[4 * j + 2 * i + 1] * f[i]);
    }
  }
}

// ---------------------------------------------------------------------------
// persistent: one block an SM walks over the work items (q tile, kv head,
// batch), sweeping the KV tiles of each
// ---------------------------------------------------------------------------

template <typename T, int D>
__global__ void __launch_bounds__((n_consumers<D>() + 1) * 128, 1)
flash_fwd_kernel(const __grid_constant__ CUtensorMap tm_q, const __grid_constant__ CUtensorMap tm_k,
                 const __grid_constant__ CUtensorMap tm_v, const __grid_constant__ CUtensorMap tm_o,
                 const FwdParams p) {
  using L = FwdSmem<D>;
  constexpr int NC = L::NC;
  constexpr int QR = L::QR;
  constexpr int NTHREADS = (NC + 1) * 128;
  constexpr int NCB = col_blocks<D>();  // 64-element column blocks of a row
  constexpr int NK = kv_rows<D>();
  constexpr int STAGES = L::STAGES;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* const smem = align1024(smem_raw);
  const uint32_t sbase = smem_u32(smem);
  uint64_t* const full_k = reinterpret_cast<uint64_t*>(smem + L::BAR);
  uint64_t* const full_v = full_k + STAGES;
  uint64_t* const empty = full_v + STAGES;
  uint64_t* const q_full = empty + STAGES;
  uint64_t* const q_empty = q_full + 1;

  const TilePlan tp = p.tp;
  const int rows_tile = tp.P * tp.Gt;
  const int n_items = p.n_tiles * p.KVH * p.B;
  const int tid = threadIdx.x;

  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full_k[s], 1);
      mbar_init(&full_v[s], 1);
      mbar_init(&empty[s], NC * 4);
    }
    mbar_init(q_full, 1);
    mbar_init(q_empty, NC * 4);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  // rows past the tile's whole positions: never loaded, 0 for good
  if (rows_tile < QR) {
    zero_rows<D, NTHREADS>(smem + L::Q, QR, rows_tile, tid);
    fence_proxy_async();
  }
  __syncthreads();

  if (tid >= NC * 128) {
    // ---- producer: per item the q tile, once its last one is no longer
    // read, then the item's (K, V) tiles into the ring
    setmaxnreg_dec<PRODUCER_REGS>();
    if (tid == NC * 128) {
      prefetch_map(&tm_q);
      prefetch_map(&tm_k);
      prefetch_map(&tm_v);
      prefetch_map(&tm_o);
      int kc = 0;  // ring slots filled so far
      int n = 0;   // items of this block so far
      for (int w = blockIdx.x; w < n_items; w += gridDim.x, ++n) {
        const Item it = item_of<NK>(p, w);
        if (n > 0) mbar_wait(q_empty, (n - 1) & 1);
        mbar_arrive_expect_tx(q_full, NCB * rows_tile * ATOM);
#pragma unroll
        for (int cb = 0; cb < NCB; ++cb)
          tma_load_5d(sbase + L::Q + cb * QR * ATOM, &tm_q, q_full, cb * 64, it.g0, it.pos0, it.h, it.b);
        for (int j = 0; j < it.n_kt; ++j, ++kc) {
          const int s = kc % STAGES;
          if (kc >= STAGES) mbar_wait(&empty[s], ((kc / STAGES) - 1) & 1);
          const uint32_t sk = sbase + L::STAGE + s * 2 * L::KV;
          mbar_arrive_expect_tx(&full_k[s], NCB * NK * ATOM);
#pragma unroll
          for (int cb = 0; cb < NCB; ++cb)
            tma_load_4d(sk + cb * NK * ATOM, &tm_k, &full_k[s], cb * 64, j * NK, it.h, it.b);
          mbar_arrive_expect_tx(&full_v[s], NCB * NK * ATOM);
#pragma unroll
          for (int cb = 0; cb < NCB; ++cb)
            tma_load_4d(sk + L::KV + cb * NK * ATOM, &tm_v, &full_v[s], cb * 64, j * NK, it.h, it.b);
        }
      }
    }
    return;
  }

  // ---- consumers: 64 folded rows each
  setmaxnreg_inc<consumer_regs<NC>()>();
  const int wg = tid >> 7;
  const int wl = (tid >> 5) & 3;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const float c2 = p.scale * LOG2E;  // exp(scale * x) = exp2(c2 * x)
  const uint32_t sq = sbase + L::Q;
  const uint32_t stage0 = sbase + L::STAGE;

  // The consumer warpgroups take turns, round robin, to issue their products
  // (hardware barrier 2 + w is warpgroup w's turn), one turn each a KV tile
  // past the first of every item, so that one's softmax runs while the
  // others' products do. The last warpgroup lets the first go first.
  if (wg == NC - 1) named_barrier_arrive(2, 256);
  int kc = 0;  // ring slots consumed so far
  int n = 0;   // items of this block so far
  for (int w = blockIdx.x; w < n_items; w += gridDim.x, ++n) {
    const Item it = item_of<NK>(p, w);
    // this thread's two rows (i = 0: row g of its warp's 16, i = 1: row g + 8)
    int pos[2], grp[2], kv_last[2];
    bool valid[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int lr = 64 * wg + 16 * wl + g + 8 * i;
      pos[i] = it.pos0 + lr / tp.Gt;
      grp[i] = it.g0 + lr % tp.Gt;
      valid[i] = lr < rows_tile && pos[i] < p.Sq && grp[i] < p.G;
      // the last kv position the row sees
      kv_last[i] = p.causal ? min(p.Skv, p.q_offset + pos[i] + 1) - 1 : p.Skv - 1;
    }
    // the KV tiles warpgroup v sweeps: the rest are wholly masked for its
    // rows, and come last
    auto live_tiles = [&](int v) {
      const int rows = min(64, rows_tile - 64 * v);  // may be <= 0: nothing to do
      const int last = p.q_offset + it.pos0 + (64 * v + rows - 1) / tp.Gt;
      return rows <= 0 ? 0 : p.causal ? min(it.n_kt, max(0, last + NK) / NK) : it.n_kt;
    };
    const int wg_rows = min(64, rows_tile - 64 * wg);
    const int n_live = live_tiles(wg);
    // the first position of this warpgroup's rows, past which a tile needs the causal mask
    const int wg_first = p.q_offset + it.pos0 + (64 * wg) / tp.Gt;
    auto needs_mask = [&](int j) {
      return (j + 1) * NK > p.Skv || (p.causal && (j + 1) * NK - 1 > wg_first);
    };
    // KV tile j of this item lies in ring slot kc + j
    auto slot = [&](int j) { return stage0 + ((kc + j) % STAGES) * 2 * L::KV; };
    auto phase = [&](int j) { return static_cast<uint32_t>(((kc + j) / STAGES) & 1); };

    float o[D / 2];
    zero(o);
    RowStats st = {{NEG_INF, NEG_INF}, {0.f, 0.f}};
    float corr[2];
    float sacc[NK / 2];
    uint32_t pf[NK / 16][4];  // p of the previous tile, A fragments of o += p.v
    mbar_wait(q_full, n & 1);

    if (n_live > 0) {
      mbar_wait(&full_k[kc % STAGES], phase(0));
      issue_s<T, D, NK, QR>(sacc, sq, slot(0), wg);
      wgmma_wait<0>();
      pin(sacc);
      softmax_tile<NK>(sacc, st, corr, needs_mask(0), 0, kv_last, t, c2);  // o is 0: corr unused
      to_a_frags<T, NK>(pf, sacc);
    }
    for (int j = 1; j < n_live; ++j) {
      // in this warpgroup's turn, the scores of this tile, then o += p.v of
      // the previous one: the softmax below runs while that product does
      named_barrier(2 + wg, 256);
      mbar_wait(&full_k[(kc + j) % STAGES], phase(j));
      mbar_wait(&full_v[(kc + j - 1) % STAGES], phase(j - 1));
      issue_s<T, D, NK, QR>(sacc, sq, slot(j), wg);
      issue_pv<T, D, NK>(o, pf, slot(j - 1) + L::KV);
      named_barrier_arrive(2 + (wg + 1) % NC, 256);
      wgmma_wait<1>();
      pin(sacc);
      softmax_tile<NK>(sacc, st, corr, needs_mask(j), j * NK, kv_last, t, c2);
      wgmma_wait<0>();
      pin(o);
      pin(pf);
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[(kc + j - 1) % STAGES]);
#pragma unroll
      for (int e = 0; e < D / 8; ++e) {
        o[4 * e + 0] *= corr[0];
        o[4 * e + 1] *= corr[0];
        o[4 * e + 2] *= corr[1];
        o[4 * e + 3] *= corr[1];
      }
      to_a_frags<T, NK>(pf, sacc);
    }
    // every s of this item has completed: the q tile may take the next item's
    __syncwarp();
    if (lane == 0) mbar_arrive(q_empty);
    if (n_live > 0) {
      // o += p.v of the last tile
      mbar_wait(&full_v[(kc + n_live - 1) % STAGES], phase(n_live - 1));
      wgmma_fence();
      issue_pv<T, D, NK>(o, pf, slot(n_live - 1) + L::KV);
      wgmma_wait<0>();
      pin(o);
      pin(pf);
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[(kc + n_live - 1) % STAGES]);
    }
    // tiles wholly masked for this warpgroup: released once they have
    // arrived, so that the ring's phases stay in step, and their turns passed on
    for (int j = n_live; j < it.n_kt; ++j) {
      if (j >= 1) {
        named_barrier(2 + wg, 256);
        named_barrier_arrive(2 + (wg + 1) % NC, 256);
      }
      mbar_wait(&full_k[(kc + j) % STAGES], phase(j));
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[(kc + j) % STAGES]);
    }
    kc += it.n_kt;

    // ---- o = acc / max(l, 1e-30) through the o tile, lse = m * scale + log(max(l, 1e-30))
    float inv[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const float l = fmaxf(quad_sum(st.l[i]), 1e-30f);
      inv[i] = 1.f / l;
      if (valid[i] && t == 0) {
        p.lse[(static_cast<long long>(it.b) * p.KVH + it.h) * p.Sq * p.G + static_cast<long long>(pos[i]) * p.G +
              grp[i]] = scaled_max(st.m[i], p.scale) + __logf(l);
      }
    }
    if (tid == 0) tma_store_wait_read();  // the last item's o has left the o tile
    named_barrier(1, NC * 128);
    if (wg_rows > 0) o_to_smem<T, D, QR>(smem + L::O, 64 * wg, o, inv, wl, g, t);
    fence_proxy_async();
    named_barrier(1, NC * 128);
    if (tid == 0) {
#pragma unroll
      for (int cb = 0; cb < NCB; ++cb)
        tma_store_5d(&tm_o, sbase + L::O + cb * QR * ATOM, cb * 64, it.g0, it.pos0, it.h, it.b);
      tma_store_commit();
    }
  }
  if (tid == 0) tma_store_wait_read();
}

template <typename T, int D>
int launch(const CUtensorMap (&m)[4], const FwdParams& p, cudaStream_t stream) {
  const int smem = FwdSmem<D>::ALLOC;
  cudaError_t err = cudaFuncSetAttribute(flash_fwd_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  int dev = 0, n_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess ||
      (err = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return static_cast<int>(err);
  const int n_items = p.n_tiles * p.KVH * p.B;
  flash_fwd_kernel<T, D><<<min(n_items, n_sm), (n_consumers<D>() + 1) * 128, smem, stream>>>(m[0], m[1], m[2], m[3], p);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int D>
int blocks_per_sm() {
  const int smem = FwdSmem<D>::ALLOC;
  int n = 0;
  if (cudaFuncSetAttribute(flash_fwd_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem) != cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, flash_fwd_kernel<T, D>, (n_consumers<D>() + 1) * 128, smem) !=
          cudaSuccess)
    return -1;
  return n;
}

}  // namespace

// Blocks of the kernel for (D, dtype) that one SM holds at once, as the CUDA
// runtime reckons it from the kernel's registers and shared memory; -1 on an
// error, ERR_NO_KERNEL for a pair that has no instantiation.
extern "C" int flash_attention_fwd_blocks_per_sm(int D, int dtype) {
  if (dtype == 0 && D == 64) return blocks_per_sm<__nv_bfloat16, 64>();
  if (dtype == 0 && D == 128) return blocks_per_sm<__nv_bfloat16, 128>();
  if (dtype == 1 && D == 64) return blocks_per_sm<__half, 64>();
  if (dtype == 1 && D == 128) return blocks_per_sm<__half, 128>();
  if (dtype == 0 && D == 112) return blocks_per_sm<__nv_bfloat16, 112>();
  if (dtype == 1 && D == 112) return blocks_per_sm<__half, 112>();
  if (dtype == 0 && D == 160) return blocks_per_sm<__nv_bfloat16, 160>();
  if (dtype == 1 && D == 160) return blocks_per_sm<__half, 160>();
  return ERR_NO_KERNEL;
}

// Strides in elements: q b,kvh,s,g | k b,kvh,s | v b,kvh,s | o b,kvh,s,g
// (14). (P, Gt, gchunks) is the tile plan of a block's folded q rows
// (FwdSmem<D>::QR: 192 at D = 64 and 112, 128 at D = 128 and 160). dtype: 0 = bf16, 1 = f16. Launches one
// kernel, one block an SM, and returns cudaGetLastError(), or one of the
// negative ERR_ codes of hopper.cuh without launching.
extern "C" int flash_attention_fwd_launch(
    const void* q, const void* k, const void* v, void* o, float* lse, const long long* s, int B, int KVH, int Sq,
    int Skv, int G, int D, int P, int Gt, int gchunks, int causal, int q_offset, float scale, int dtype,
    void* stream) {
  FwdParams p;
  p.lse = lse;
  p.B = B; p.KVH = KVH; p.Sq = Sq; p.Skv = Skv; p.G = G;
  p.tp = TilePlan{P, Gt, gchunks};
  p.n_tiles = ((Sq + P - 1) / P) * gchunks;
  p.causal = causal; p.q_offset = q_offset; p.scale = scale;
  if (!((D == 64 || D == 112 || D == 128 || D == 160) && (dtype == 0 || dtype == 1))) return ERR_NO_KERNEL;
  const int qr = D == 64 ? FwdSmem<64>::QR : D == 112 ? FwdSmem<112>::QR : D == 128 ? FwdSmem<128>::QR
                                                                                     : FwdSmem<160>::QR;
  if (!plan_ok(p.tp, G, qr)) return ERR_PLAN;
  CUtensorMap m[4];
  const int nk = D == 64 ? kv_rows<64>() : D == 112 ? kv_rows<112>() : D == 128 ? kv_rows<128>() : kv_rows<160>();
  int r;
  if ((r = map_folded(&m[0], q, dtype, s, B, KVH, Sq, G, D, p.tp)) != 0) return r;
  if ((r = map_kv(&m[1], k, dtype, s + 4, B, KVH, Skv, D, nk)) != 0) return r;
  if ((r = map_kv(&m[2], v, dtype, s + 7, B, KVH, Skv, D, nk)) != 0) return r;
  if ((r = map_folded(&m[3], o, dtype, s + 10, B, KVH, Sq, G, D, p.tp)) != 0) return r;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && D == 64) return launch<__nv_bfloat16, 64>(m, p, st);
  if (dtype == 0 && D == 128) return launch<__nv_bfloat16, 128>(m, p, st);
  if (dtype == 1 && D == 64) return launch<__half, 64>(m, p, st);
  if (dtype == 1 && D == 128) return launch<__half, 128>(m, p, st);
  if (dtype == 0 && D == 112) return launch<__nv_bfloat16, 112>(m, p, st);
  if (dtype == 1 && D == 112) return launch<__half, 112>(m, p, st);
  if (dtype == 0) return launch<__nv_bfloat16, 160>(m, p, st);
  return launch<__half, 160>(m, p, st);
}
