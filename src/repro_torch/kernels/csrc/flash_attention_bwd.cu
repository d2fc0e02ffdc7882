// Causal / full GQA flash-attention backward for Hopper (sm_90a): two kernels.
//
// Replaces the TPU kernels of repro/kernels/flash_attention.py::flash_attention_bwd:
//   * flash_bwd_dq_kernel  <- _bwd_dq_kernel (second pallas_call, grid B,KVH,nq,nk):
//     for one tile of folded q rows, sweep the KV tiles: p = exp(s - lse),
//     ds = p o (do.v^T - delta), dq += scale * ds.k. It also computes
//     delta = sum_d o*do for its rows (the reference computes it outside its
//     kernels) and writes it for the dk/dv kernel, which runs after it.
//   * flash_bwd_dkv_kernel <- _bwd_dkv_kernel (first pallas_call, grid B,KVH,nk,nq):
//     for one KV tile, sweep the q tiles: the same p and ds, dv += p^T.do,
//     dk += scale * ds^T.q. The G folded rows of a q tile all meet the same KV
//     head, so summing over rows is what reduces the GQA gradients onto it.
// Both recompute p from q, k and the forward's lse, so no S x S tensor exists.
//
// What bounds them on this card: operations. At the training shape
// (q (2,8,4096,4,64), k/v (2,8,4096,64), causal) the dk/dv kernel needs
// 8*D FLOP per live (row, key) pair (s, dp, dv, dk), 275 GFLOP, and the dq
// kernel 6*D (s, dp, dq), 206 GFLOP, against about 100 MB of traffic each: far
// above the card's ~295 FLOP/byte ridge.
//
// What the design does about it:
//   * every product is a warpgroup wgmma.mma_async (m64nNk16, f32 accumulate),
//     the only way to the tensor cores' full rate. B always comes from shared
//     memory; A from shared memory for the resident tiles (K, V in the dk/dv
//     kernel, q, do in the dq kernel) and from registers for p^T, ds^T and
//     ds, which go from the f32 accumulator straight to a 16-bit A fragment.
//     Where B is stored MN-major (do and q for dv and dk, K for dq), the
//     instruction transposes it;
//   * tiles lie in shared memory in the 128-byte swizzle that both TMA and the
//     wgmma descriptors read: a row of 64 elements is one swizzle atom, and a
//     row of 128 two column blocks of 64;
//   * the swept tiles arrive by TMA into a ring of STAGES buffers with
//     mbarriers, issued by one producer warp; the two consumer warpgroups take
//     its registers with setmaxnreg. q and do are read through a 5-D tensor
//     map (D, G, S, KVH, B) whose box is a tile of whole positions, so the GQA
//     fold stays a view; k, v through a 4-D map (D, S, KVH, B);
//   * larger tiles, so that every fetched tile serves more work: the dk/dv
//     kernel owns 128 KV rows a block (64 a consumer warpgroup) against q tiles
//     of 64 folded rows, and the dq kernel 128 folded q rows against KV tiles
//     of 128 (64 at D = 128 and 160). dk and dv (dq) stay in registers for
//     the whole sweep, and each kernel writes its outputs once: no atomics, no
//     second pass, and two runs give the same bits;
//   * at D = 112 (zamba2-7b) a row is one and three quarter swizzle atoms: two
//     64-element column blocks, the last 16 columns past the tensor maps'
//     extent of D, so TMA zero-fills them and no product reads them (the s
//     and dp products take 7 k16 steps; dv, dk and dq are m64n112k16 wgmma).
//     dk and dv of 64 rows take 112 registers a thread (128 at D = 128), so
//     a dk/dv block owns 128 KV rows as at 128 (a split as at 160 took 1.36
//     ms against 0.90); the dq kernel sweeps 128-row (K, V) tiles as at 64,
//     in a ring of 2 (192 KB of shared memory with q and do);
//   * at D = 160 (stablelm-12b) a row is two and a half swizzle atoms: three
//     64-element column blocks, the last 32 columns past the tensor maps'
//     extent of D, so TMA zero-fills them and no product reads them (the
//     s and dp products take 10 k16 steps; dv, dk and dq are m64n160k16
//     wgmma). dk and dv of 64 rows would take 160 registers a thread, so
//     there a dk/dv block owns 64 KV rows, warpgroup 0 holding their dv and
//     warpgroup 1 their dk (dkv_split), and the dq kernel's ring is 2 deep;
//   * the softmax costs few instructions, since each step's tensor work waits
//     for it: one ex2.approx.ftz an element, and the mask test outside the
//     element loop (a tile that needs no mask runs a loop without one);
//   * causal sweeps start (dk/dv) or end (dq) at the diagonal, tiles a
//     warpgroup would find wholly masked are skipped, blocks are scheduled
//     heaviest first (the tile index is the slowest grid axis), and only tiles
//     on the diagonal or a ragged edge are masked. Rows past the end or past
//     the whole positions of a tile read as 0 (TMA's out-of-bounds fill, or
//     zeroed once), with lse and delta 0: they add exactly 0 to every output.
// What it does not do: FA3's fused form (the dk/dv kernel also adding dq by f32
// atomics, then a convert pass), which does 10*D FLOP per pair instead of
// 14*D but gives up determinism; ping-pong of one warpgroup's softmax against
// the other's products. Each step waits for its own products before the next
// one starts: with commit groups left in flight across the loop's back edge,
// ptxas serializes every wgmma (its message C7515).
//
// Differences from the TPU kernels, on purpose:
//   * the sequential grid axis of each TPU kernel is a loop inside one block;
//   * tiles are 64-128 rows (the TPU default of 512 x 512 with G = 4 is 2,048
//     rows, far beyond one SM);
//   * the ragged edges are masked, so any Sq, Skv >= 1 works (the TPU entry
//     needs lengths that divide its blocks);
//   * p and ds are rounded to the input type as tensor-core operands; the
//     softmax algebra stays f32.
//
// The tile plan (positions a tile, groups a tile, tiles along G when G exceeds
// the tile) is computed by the Python wrapper, which also checks what the
// tensor maps need: last dim contiguous, strides multiples of 16 bytes,
// 16-byte aligned storage. The building blocks (barriers, TMA, wgmma and its
// descriptors, the tensor maps) are in hopper.cuh, shared with the forward.

#include "hopper.cuh"

namespace {

constexpr int NCONSUMER = 2;                      // consumer warpgroups a block
constexpr int NTHREADS = (NCONSUMER + 1) * 128;   // + one producer warpgroup
constexpr int DQ_ROWS = 128;   // folded q rows a block of the dq kernel owns
constexpr int SWEEP_ROWS = 64;  // folded q rows of a swept tile of the dk/dv kernel
constexpr int CONSUMER_REGS = 240;
constexpr int PRODUCER_REGS = 24;

// KV rows of a swept tile of the dq kernel: 128 at D = 64 and 112 (s, dp and
// dq then take 160 and 184 of a consumer's 240 registers), 64 at D = 128 and
// 160 (dq alone takes 64 and 80). At 112 the 128-row tiles, in a ring of 2,
// took 0.659 ms against 0.702 for 64-row tiles in a ring of 3 (H100, zamba2's
// training shape; examples/profile_flash_bwd_torch.py, variant dq128_112).
template <int D>
__host__ __device__ constexpr int dq_kv_rows() {
  return D == 64 || D == 112 ? 128 : 64;
}

// Depth of the dq kernel's ring of (K, V) tiles: 3, and 2 at D = 112 and 160,
// where three would not fit beside the q and do tiles (32 KB each and 32 KB a
// K or V tile at 112; 48 and 24 KB at 160). The dk/dv kernel keeps 3 (its
// resident K and V tiles are 24 KB each at D = 160).
template <int D>
__host__ __device__ constexpr int dq_stages() {
  return D == 112 || D == 160 ? 2 : 3;
}
constexpr int DKV_STAGES = 3;

// How the dk/dv kernel splits its work. At D = 64, 112 and 128 each consumer
// warpgroup owns 64 KV rows and holds their dk and dv (a block owns 128). At
// D = 160 dk and dv would take 160 of a thread's registers before s and dp
// (the most is 255): there the block owns 64 KV rows, warpgroup 0 holds their
// dv and warpgroup 1 their dk. Both compute s = k.q^T (one product more per
// pair, 5 * 2D FLOP instead of 4 * 2D); only warpgroup 1 computes dp.
template <int D>
__host__ __device__ constexpr bool dkv_split() {
  return D == 160;
}
template <int D>
__host__ __device__ constexpr int dkv_own_rows() {
  return dkv_split<D>() ? 64 : 128;
}

struct DqParams {
  const void* o;
  const void* dout;
  const float* lse;  // (B,KVH,Sq,G) contiguous
  float* delta;      // (B,KVH,Sq,G) contiguous, written
  void* dq;
  long long o_sb, o_sh, o_ss, o_sg;
  long long do_sb, do_sh, do_ss, do_sg;
  long long dq_sb, dq_sh, dq_ss, dq_sg;
  int KVH, Sq, Skv, G;
  TilePlan tp;
  int causal, q_offset;
  float scale;
};

struct DkvParams {
  const float* lse;    // (B,KVH,Sq,G) contiguous
  const float* delta;  // (B,KVH,Sq,G) contiguous, from the dq kernel
  void* dk;
  void* dv;
  long long dk_sb, dk_sh, dk_ss;
  long long dv_sb, dv_sh, dv_ss;
  int KVH, Sq, Skv, G;
  TilePlan tp;
  int causal, q_offset;
  float scale;
};

// Shared memory of the dq kernel: the resident q and do tiles (DQ_ROWS
// rows each), STAGES x (K, V) tiles (dq_kv_rows rows each), each row
// col_blocks<D> swizzled 128-byte blocks, then the barriers. Every tile
// starts on a 1024-byte boundary, as the 128-byte swizzle needs.
template <int D>
struct DqSmem {
  static constexpr int STAGES = dq_stages<D>();
  static constexpr int OWN = DQ_ROWS * col_blocks<D>() * ATOM;
  static constexpr int SWEEP = dq_kv_rows<D>() * col_blocks<D>() * ATOM;
  static constexpr int Q = 0, DO = OWN, STAGE = 2 * OWN;
  static constexpr int BAR = STAGE + STAGES * 2 * SWEEP;  // full[STAGES], empty[STAGES], q
  static constexpr int BYTES = BAR + (2 * STAGES + 1) * 8;
  static constexpr int ALLOC = BYTES + 1024;  // room to align the base
  static_assert(ALLOC <= 232448, "more shared memory than a block may use");
};

// Shared memory of the dk/dv kernel: the resident K and V tiles
// (dkv_own_rows rows each), STAGES x (q, do) tiles (SWEEP_ROWS rows each),
// each row col_blocks<D> swizzled 128-byte blocks, STAGES x (-lse log2 e,
// delta) of SWEEP_ROWS floats, the position of each row of a q tile, then the
// barriers.
template <int D>
struct DkvSmem {
  static constexpr int STAGES = DKV_STAGES;
  static constexpr int OWN = dkv_own_rows<D>() * col_blocks<D>() * ATOM;
  static constexpr int SWEEP = SWEEP_ROWS * col_blocks<D>() * ATOM;
  static constexpr int K = 0, V = OWN, STAGE = 2 * OWN;
  static constexpr int STATS = STAGE + STAGES * 2 * SWEEP;
  static constexpr int POS = STATS + STAGES * 2 * SWEEP_ROWS * 4;
  static constexpr int BAR = POS + SWEEP_ROWS * 4;  // full[STAGES], empty[STAGES], kv
  static constexpr int BYTES = BAR + (2 * STAGES + 1) * 8;
  static constexpr int ALLOC = BYTES + 1024;
  static_assert(ALLOC <= 232448, "more shared memory than a block may use");
};

// p^T = exp(scale * s^T - lse) of one (64 kv rows x 64 folded q rows) tile in
// place, masked to 0 on a diagonal tile only (``masked``): this thread's kv
// rows are kv_a and kv_b, its columns' -lse log2 e are ``nlc``, and the
// position of column c is first + qpos[c].
__device__ __forceinline__ void dkv_probs(float (&sacc)[32], const float2 (&nlc)[8], const int* qpos, int first,
                                          bool masked, int kv_a, int kv_b, float c2, int t) {
  if (masked) {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int2 qp = *reinterpret_cast<const int2*>(qpos + 8 * j + 2 * t);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const bool live = first + ((e & 1) ? qp.y : qp.x) >= ((e >> 1) ? kv_b : kv_a);
        sacc[4 * j + e] = live ? exp2_ftz(fmaf(sacc[4 * j + e], c2, (e & 1) ? nlc[j].y : nlc[j].x)) : 0.f;
      }
    }
  } else {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e)
        sacc[4 * j + e] = exp2_ftz(fmaf(sacc[4 * j + e], c2, (e & 1) ? nlc[j].y : nlc[j].x));
    }
  }
}

// ds^T = p^T o (dp^T - delta) in place, the columns' delta at ``dl``
__device__ __forceinline__ void dkv_ds(float (&sacc)[32], const float (&dpacc)[32], const float* dl, int t) {
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const float2 d2 = *reinterpret_cast<const float2*>(dl + 8 * j + 2 * t);
#pragma unroll
    for (int e = 0; e < 4; ++e) sacc[4 * j + e] *= dpacc[4 * j + e] - ((e & 1) ? d2.y : d2.x);
  }
}


// ---------------------------------------------------------------------------
// dq (and delta): one block per (q tile, kv head, batch); sweeps the KV tiles
// ---------------------------------------------------------------------------

template <typename T, int D>
__global__ void __launch_bounds__(NTHREADS, 1)
flash_bwd_dq_kernel(const __grid_constant__ CUtensorMap tm_q, const __grid_constant__ CUtensorMap tm_do,
                    const __grid_constant__ CUtensorMap tm_k, const __grid_constant__ CUtensorMap tm_v,
                    const DqParams p) {
  using L = DqSmem<D>;
  constexpr int NCB = col_blocks<D>();  // 64-element column blocks of a row
  constexpr int NK = dq_kv_rows<D>();
  constexpr int STAGES = L::STAGES;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* const smem = align1024(smem_raw);
  const uint32_t sbase = smem_u32(smem);
  uint64_t* const full = reinterpret_cast<uint64_t*>(smem + L::BAR);
  uint64_t* const empty = full + STAGES;
  uint64_t* const qbar = empty + STAGES;

  const TilePlan tp = p.tp;
  const int rows_tile = tp.P * tp.Gt;
  // heaviest (latest) causal tiles first: the tile is the slowest grid axis
  const int tile = gridDim.z - 1 - blockIdx.z;
  const int pos0 = (tile / tp.gchunks) * tp.P;
  const int g0 = (tile % tp.gchunks) * tp.Gt;
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int tid = threadIdx.x;

  // causal: KV tiles wholly above the diagonal of this block are never visited
  int kv_end = p.Skv;
  if (p.causal) kv_end = min(p.Skv, p.q_offset + min(pos0 + tp.P, p.Sq));
  const int n_kt = (kv_end + NK - 1) / NK;

  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], NCONSUMER * 4);
    }
    mbar_init(qbar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  if (rows_tile < DQ_ROWS) {
    zero_rows<D, NTHREADS>(smem + L::Q, DQ_ROWS, rows_tile, tid);
    zero_rows<D, NTHREADS>(smem + L::DO, DQ_ROWS, rows_tile, tid);
    fence_proxy_async();
  }
  __syncthreads();

  if (tid >= NCONSUMER * 128) {
    // ---- producer: the q and do tiles once, then the ring of (K, V) tiles
    setmaxnreg_dec<PRODUCER_REGS>();
    if (tid == NCONSUMER * 128) {
      prefetch_map(&tm_q);
      prefetch_map(&tm_do);
      prefetch_map(&tm_k);
      prefetch_map(&tm_v);
      mbar_arrive_expect_tx(qbar, 2 * NCB * rows_tile * ATOM);
#pragma unroll
      for (int cb = 0; cb < NCB; ++cb) {
        tma_load_5d(sbase + L::Q + cb * DQ_ROWS * ATOM, &tm_q, qbar, cb * 64, g0, pos0, h, b);
        tma_load_5d(sbase + L::DO + cb * DQ_ROWS * ATOM, &tm_do, qbar, cb * 64, g0, pos0, h, b);
      }
      for (int it = 0; it < n_kt; ++it) {
        const int s = it % STAGES;
        if (it >= STAGES) mbar_wait(&empty[s], ((it / STAGES) - 1) & 1);
        mbar_arrive_expect_tx(&full[s], 2 * NCB * NK * ATOM);
        const uint32_t sk = sbase + L::STAGE + s * 2 * L::SWEEP;
#pragma unroll
        for (int cb = 0; cb < NCB; ++cb) {
          tma_load_4d(sk + cb * NK * ATOM, &tm_k, &full[s], cb * 64, it * NK, h, b);
          tma_load_4d(sk + L::SWEEP + cb * NK * ATOM, &tm_v, &full[s], cb * 64, it * NK, h, b);
        }
      }
    }
  } else {
    // ---- consumers: 64 folded rows each
    setmaxnreg_inc<CONSUMER_REGS>();
    const int wg = tid >> 7;
    const int wl = (tid >> 5) & 3;
    const int lane = tid & 31;
    const int g = lane >> 2;
    const int t = lane & 3;
    const int R = p.Sq * p.G;
    const long long stat0 = (static_cast<long long>(b) * p.KVH + h) * R;

    // this thread's two rows (i = 0: row g of its warp's 16, i = 1: row g + 8)
    int pos[2], grp[2];
    bool valid[2];
    float nl[2], dl[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int lr = 64 * wg + 16 * wl + g + 8 * i;
      pos[i] = pos0 + lr / tp.Gt;
      grp[i] = g0 + lr % tp.Gt;
      valid[i] = lr < rows_tile && pos[i] < p.Sq && grp[i] < p.G;
      const long long row = static_cast<long long>(pos[i]) * p.G + grp[i];
      nl[i] = valid[i] ? -p.lse[stat0 + row] * LOG2E : 0.f;
      // delta = sum_d o*do in f32: the 4 lanes of a quad share the row's 16-byte chunks
      float part = 0.f;
      if (valid[i]) {
        const T* orow = static_cast<const T*>(p.o) + b * p.o_sb + h * p.o_sh + pos[i] * p.o_ss + grp[i] * p.o_sg;
        const T* drow = static_cast<const T*>(p.dout) + b * p.do_sb + h * p.do_sh + pos[i] * p.do_ss +
                        grp[i] * p.do_sg;
#pragma unroll
        for (int c = t; c < D / 8; c += 4) {
          const uint4 ov = *reinterpret_cast<const uint4*>(orow + 8 * c);
          const uint4 dv = *reinterpret_cast<const uint4*>(drow + 8 * c);
          const T* oe = reinterpret_cast<const T*>(&ov);
          const T* de = reinterpret_cast<const T*>(&dv);
#pragma unroll
          for (int e = 0; e < 8; ++e) part = fmaf(static_cast<float>(oe[e]), static_cast<float>(de[e]), part);
        }
      }
      part += __shfl_xor_sync(0xffffffffu, part, 1);
      part += __shfl_xor_sync(0xffffffffu, part, 2);
      dl[i] = part;
      if (valid[i] && t == 0) p.delta[stat0 + row] = part;
    }

    // this warpgroup's rows: which KV tiles it can skip, which it must mask
    const int wg_rows = min(64, rows_tile - 64 * wg);  // may be <= 0: nothing to do
    const int wg_first = p.q_offset + pos0 + (64 * wg) / tp.Gt;
    const int wg_last = p.q_offset + pos0 + (64 * wg + max(wg_rows, 1) - 1) / tp.Gt;
    // the last kv position each of the two rows sees
    const int kv_last[2] = {p.causal ? min(p.Skv, p.q_offset + pos[0] + 1) - 1 : p.Skv - 1,
                            p.causal ? min(p.Skv, p.q_offset + pos[1] + 1) - 1 : p.Skv - 1};
    const float c2 = p.scale * LOG2E;  // exp(scale * s - lse) = exp2(c2 * s - lse * log2(e))
    const uint32_t sq = sbase + L::Q;
    const uint32_t sdo = sbase + L::DO;

    float dq[D / 2];
    zero(dq);
    mbar_wait(qbar, 0);

    for (int it = 0; it < n_kt; ++it) {
      const int s = it % STAGES;
      const int kv0 = it * NK;
      mbar_wait(&full[s], (it / STAGES) & 1);
      const bool dead = wg_rows <= 0 || (p.causal && kv0 > wg_last);
      if (!dead) {
        const uint32_t sk = sbase + L::STAGE + s * 2 * L::SWEEP;
        const uint32_t sv = sk + L::SWEEP;
        float sacc[NK / 2], dpacc[NK / 2];
        // s = q.k^T and dp = do.v^T, 64 x NK a warpgroup
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk)
          mma_ss<T, NK>(sacc, desc_k(sq, DQ_ROWS, 64 * wg, kk), desc_k(sk, NK, 0, kk), kk > 0);
        wgmma_commit();
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk)
          mma_ss<T, NK>(dpacc, desc_k(sdo, DQ_ROWS, 64 * wg, kk), desc_k(sv, NK, 0, kk), kk > 0);
        wgmma_commit();
        wgmma_wait<1>();
        pin(sacc);

        // p = exp(scale * s - lse), masked to 0 on a diagonal or ragged tile only
        if ((kv0 + NK > p.Skv) || (p.causal && kv0 + NK - 1 > wg_first)) {
#pragma unroll
          for (int j = 0; j < NK / 8; ++j) {
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int kv = kv0 + 8 * j + 2 * t + (e & 1);
              sacc[4 * j + e] = kv <= kv_last[e >> 1] ? exp2_ftz(fmaf(sacc[4 * j + e], c2, nl[e >> 1])) : 0.f;
            }
          }
        } else {
#pragma unroll
          for (int j = 0; j < NK / 8; ++j) {
#pragma unroll
            for (int e = 0; e < 4; ++e) sacc[4 * j + e] = exp2_ftz(fmaf(sacc[4 * j + e], c2, nl[e >> 1]));
          }
        }
        wgmma_wait<0>();
        pin(dpacc);
        // ds = p o (dp - delta)
#pragma unroll
        for (int j = 0; j < NK / 8; ++j) {
#pragma unroll
          for (int e = 0; e < 4; ++e) sacc[4 * j + e] *= dpacc[4 * j + e] - dl[e >> 1];
        }
        uint32_t dsf[NK / 16][4];
        to_a_frags<T, NK>(dsf, sacc);

        // dq += ds.k (k read transposed: its rows are the k dim)
        wgmma_fence();
        pin(dq);
#pragma unroll
        for (int kk = 0; kk < NK / 16; ++kk) mma_rs<T, D>(dq, dsf[kk], desc_mn(sk, NK, kk));
        wgmma_commit();
        wgmma_wait<0>();
        pin(dq);
        pin(dsf);
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[s]);
    }

    T* dqb = static_cast<T*>(p.dq) + b * p.dq_sb + h * p.dq_sh;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      if (valid[i]) {
        store_row<T, D>(dqb + static_cast<long long>(pos[i]) * p.dq_ss + static_cast<long long>(grp[i]) * p.dq_sg,
                        dq, i, p.scale, t);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// dk, dv: one block per (kv tile, kv head, batch); sweeps the q tiles
// ---------------------------------------------------------------------------

template <typename T, int D>
__global__ void __launch_bounds__(NTHREADS, 1)
flash_bwd_dkv_kernel(const __grid_constant__ CUtensorMap tm_q, const __grid_constant__ CUtensorMap tm_do,
                     const __grid_constant__ CUtensorMap tm_k, const __grid_constant__ CUtensorMap tm_v,
                     const DkvParams p) {
  using L = DkvSmem<D>;
  constexpr int NCB = col_blocks<D>();
  constexpr int STAGES = L::STAGES;
  constexpr int OWN = dkv_own_rows<D>();
  constexpr bool SPLIT = dkv_split<D>();
  extern __shared__ unsigned char smem_raw[];
  unsigned char* const smem = align1024(smem_raw);
  const uint32_t sbase = smem_u32(smem);
  float* const stats = reinterpret_cast<float*>(smem + L::STATS);
  int* const qpos = reinterpret_cast<int*>(smem + L::POS);
  uint64_t* const full = reinterpret_cast<uint64_t*>(smem + L::BAR);
  uint64_t* const empty = full + STAGES;
  uint64_t* const kvbar = empty + STAGES;

  const TilePlan tp = p.tp;
  const int rows_tile = tp.P * tp.Gt;
  // heaviest first: under the causal mask KV tile 0 meets every q tile
  const int kv0 = blockIdx.z * OWN;
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int tid = threadIdx.x;

  // causal: the first q tile holding a position that reaches kv0
  const int n_pt = (p.Sq + tp.P - 1) / tp.P;
  int pt_begin = 0;
  if (p.causal && kv0 > p.q_offset) pt_begin = min(n_pt, (kv0 - p.q_offset) / tp.P);
  const int tile_begin = pt_begin * tp.gchunks;
  const int n_iter = n_pt * tp.gchunks - tile_begin;

  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 32);  // the producer warp's lanes, after their stats stores
      mbar_init(&empty[s], NCONSUMER * 4);
    }
    mbar_init(kvbar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  for (int i = tid; i < SWEEP_ROWS; i += NTHREADS) qpos[i] = i / tp.Gt;
  if (rows_tile < SWEEP_ROWS) {
    for (int s = 0; s < STAGES; ++s) {
      zero_rows<D, NTHREADS>(smem + L::STAGE + s * 2 * L::SWEEP, SWEEP_ROWS, rows_tile, tid);
      zero_rows<D, NTHREADS>(smem + L::STAGE + s * 2 * L::SWEEP + L::SWEEP, SWEEP_ROWS, rows_tile, tid);
    }
    fence_proxy_async();
  }
  __syncthreads();

  if (tid >= NCONSUMER * 128) {
    // ---- producer warp: the K and V tiles once, then the ring of (q, do,
    // -lse log2 e, delta); the tiles by TMA, the row statistics by its lanes
    setmaxnreg_dec<PRODUCER_REGS>();
    if (tid < NCONSUMER * 128 + 32 && n_iter > 0) {
      const int lane = tid & 31;
      if (lane == 0) {
        prefetch_map(&tm_q);
        prefetch_map(&tm_do);
        prefetch_map(&tm_k);
        prefetch_map(&tm_v);
        mbar_arrive_expect_tx(kvbar, 2 * NCB * OWN * ATOM);
#pragma unroll
        for (int cb = 0; cb < NCB; ++cb) {
          tma_load_4d(sbase + L::K + cb * OWN * ATOM, &tm_k, kvbar, cb * 64, kv0, h, b);
          tma_load_4d(sbase + L::V + cb * OWN * ATOM, &tm_v, kvbar, cb * 64, kv0, h, b);
        }
      }
      const long long stat0 = (static_cast<long long>(b) * p.KVH + h) * p.Sq * p.G;
      for (int it = 0; it < n_iter; ++it) {
        const int s = it % STAGES;
        const int tile = tile_begin + it;
        const int pos0 = (tile / tp.gchunks) * tp.P;
        const int g0 = (tile % tp.gchunks) * tp.Gt;
        if (it >= STAGES) mbar_wait(&empty[s], ((it / STAGES) - 1) & 1);
        if (lane == 0) {
          mbar_expect_tx(&full[s], 2 * NCB * rows_tile * ATOM);
          const uint32_t sq = sbase + L::STAGE + s * 2 * L::SWEEP;
#pragma unroll
          for (int cb = 0; cb < NCB; ++cb) {
            tma_load_5d(sq + cb * SWEEP_ROWS * ATOM, &tm_q, &full[s], cb * 64, g0, pos0, h, b);
            tma_load_5d(sq + L::SWEEP + cb * SWEEP_ROWS * ATOM, &tm_do, &full[s], cb * 64, g0, pos0, h, b);
          }
        }
        // rows past the end or past the tile's whole positions: lse and delta 0
        float* st = stats + s * 2 * SWEEP_ROWS;
        for (int i = lane; i < SWEEP_ROWS; i += 32) {
          const int pos = pos0 + i / tp.Gt;
          const int gg = g0 + i % tp.Gt;
          const bool in = i < rows_tile && pos < p.Sq && gg < p.G;
          const long long row = stat0 + static_cast<long long>(pos) * p.G + gg;
          st[i] = in ? -p.lse[row] * LOG2E : 0.f;
          st[SWEEP_ROWS + i] = in ? p.delta[row] : 0.f;
        }
        mbar_arrive(&full[s]);
      }
    }
    return;
  }

  // ---- consumers: 64 kv rows each (SPLIT: the same 64 for both), their dk
  // and dv (SPLIT: dv in warpgroup 0, dk in warpgroup 1) in registers for the
  // whole sweep
  setmaxnreg_inc<CONSUMER_REGS>();
  const int wg = tid >> 7;
  const int wl = (tid >> 5) & 3;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int krow = SPLIT ? 0 : 64 * wg;  // this warpgroup's first row of the K and V tiles
  const int kv_w = kv0 + krow;           // and its kv position
  const int kv_a = kv_w + 16 * wl + g;
  const int kv_b = kv_a + 8;
  const float c2 = p.scale * LOG2E;
  const uint32_t sk = sbase + L::K;
  const uint32_t sv = sbase + L::V;

  float dk[SPLIT ? 1 : D / 2], acc[D / 2];  // acc: dv, or (SPLIT) this warpgroup's dk or dv
  zero(dk);
  zero(acc);
  if (n_iter > 0) mbar_wait(kvbar, 0);

  for (int it = 0; it < n_iter; ++it) {
    const int s = it % STAGES;
    const int tile = tile_begin + it;
    const int first = p.q_offset + (tile / tp.gchunks) * tp.P;  // first position of the q tile
    mbar_wait(&full[s], (it / STAGES) & 1);
    // every position of the tile before this warpgroup's first kv row: all masked
    const bool dead = p.causal && first + tp.P - 1 < kv_w;
    if (!dead) {
      const uint32_t sq = sbase + L::STAGE + s * 2 * L::SWEEP;
      const uint32_t sdo = sq + L::SWEEP;
      const float* nl = stats + s * 2 * SWEEP_ROWS;
      const float* dl = nl + SWEEP_ROWS;
      float2 nlc[8];  // -lse log2 e of this thread's columns 8 j + 2 t, + 1
#pragma unroll
      for (int j = 0; j < 8; ++j) nlc[j] = *reinterpret_cast<const float2*>(nl + 8 * j + 2 * t);
      const bool masked = p.causal && first < kv_w + 63;
      // the accumulator that dk += ds^T.q adds to
      float(&dk_acc)[D / 2] = [&]() -> float(&)[D / 2] {
        if constexpr (SPLIT) return acc;
        else return dk;
      }();
      float sacc[32], dpacc[32];
      // Each path issues, commits and waits for its own products: with a
      // wgmma group left open across paths that differ, ptxas serializes
      // every wgmma of the kernel (its message C7520).
      if (SPLIT && wg == 0) {
        // s^T = k.q^T, 64 kv rows x 64 folded rows, then dv += p^T.do (do
        // read transposed: its rows are the k dim)
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk)
          mma_ss<T, 64>(sacc, desc_k(sk, OWN, krow, kk), desc_k(sq, SWEEP_ROWS, 0, kk), kk > 0);
        wgmma_commit();
        wgmma_wait<0>();
        pin(sacc);
        dkv_probs(sacc, nlc, qpos, first, masked, kv_a, kv_b, c2, t);
        uint32_t pf[4][4];
        to_a_frags<T, 64>(pf, sacc);
        wgmma_fence();
        pin(acc);
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) mma_rs<T, D>(acc, pf[kk], desc_mn(sdo, SWEEP_ROWS, kk));
        wgmma_commit();
        wgmma_wait<0>();
        pin(acc);
        pin(pf);
      } else {
        // s^T = k.q^T and dp^T = v.do^T, 64 kv rows x 64 folded rows
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk)
          mma_ss<T, 64>(sacc, desc_k(sk, OWN, krow, kk), desc_k(sq, SWEEP_ROWS, 0, kk), kk > 0);
        wgmma_commit();
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk)
          mma_ss<T, 64>(dpacc, desc_k(sv, OWN, krow, kk), desc_k(sdo, SWEEP_ROWS, 0, kk), kk > 0);
        wgmma_commit();
        wgmma_wait<1>();
        pin(sacc);
        dkv_probs(sacc, nlc, qpos, first, masked, kv_a, kv_b, c2, t);
        uint32_t pf[4][4];  // (not SPLIT) p, read by the dv product until the last wait
        if constexpr (!SPLIT) {
          // dv += p^T.do
          to_a_frags<T, 64>(pf, sacc);
          wgmma_fence();
          pin(acc);
#pragma unroll
          for (int kk = 0; kk < 4; ++kk) mma_rs<T, D>(acc, pf[kk], desc_mn(sdo, SWEEP_ROWS, kk));
          wgmma_commit();
          wgmma_wait<1>();
        } else {
          wgmma_wait<0>();
        }
        // ds^T = p^T o (dp^T - delta), then dk += ds^T.q (times scale at the end)
        pin(dpacc);
        dkv_ds(sacc, dpacc, dl, t);
        uint32_t dsf[4][4];
        to_a_frags<T, 64>(dsf, sacc);
        wgmma_fence();
        pin(dk_acc);
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) mma_rs<T, D>(dk_acc, dsf[kk], desc_mn(sq, SWEEP_ROWS, kk));
        wgmma_commit();
        wgmma_wait<0>();
        pin(acc);
        pin(dk_acc);
        pin(dsf);
        if constexpr (!SPLIT) pin(pf);
      }
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[s]);
  }

  T* dkb = static_cast<T*>(p.dk) + b * p.dk_sb + h * p.dk_sh;
  T* dvb = static_cast<T*>(p.dv) + b * p.dv_sb + h * p.dv_sh;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int kv = i ? kv_b : kv_a;
    if (kv >= p.Skv) continue;
    T* const dk_row = dkb + static_cast<long long>(kv) * p.dk_ss;
    T* const dv_row = dvb + static_cast<long long>(kv) * p.dv_ss;
    if constexpr (SPLIT) {
      if (wg == 1) store_row<T, D>(dk_row, acc, i, p.scale, t);
      else store_row<T, D>(dv_row, acc, i, 1.f, t);
    } else {
      store_row<T, D>(dk_row, dk, i, p.scale, t);
      store_row<T, D>(dv_row, acc, i, 1.f, t);
    }
  }
}


template <typename T, int D>
int launch_dq(const CUtensorMap (&m)[4], const DqParams& p, int B, cudaStream_t stream) {
  const int smem = DqSmem<D>::ALLOC;
  const cudaError_t err =
      cudaFuncSetAttribute(flash_bwd_dq_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(p.KVH, B, ((p.Sq + p.tp.P - 1) / p.tp.P) * p.tp.gchunks);
  flash_bwd_dq_kernel<T, D><<<grid, NTHREADS, smem, stream>>>(m[0], m[1], m[2], m[3], p);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int D>
int launch_dkv(const CUtensorMap (&m)[4], const DkvParams& p, int B, cudaStream_t stream) {
  const int smem = DkvSmem<D>::ALLOC;
  const cudaError_t err =
      cudaFuncSetAttribute(flash_bwd_dkv_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(p.KVH, B, (p.Skv + dkv_own_rows<D>() - 1) / dkv_own_rows<D>());
  flash_bwd_dkv_kernel<T, D><<<grid, NTHREADS, smem, stream>>>(m[0], m[1], m[2], m[3], p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Strides in elements. The dq entry: q b,kvh,s,g | k b,kvh,s | v b,kvh,s |
// o b,kvh,s,g | do b,kvh,s,g | dq b,kvh,s,g (22); it fills dq and delta. The
// dk/dv entry: q b,kvh,s,g | k b,kvh,s | v b,kvh,s | do b,kvh,s,g |
// dk b,kvh,s | dv b,kvh,s (20); it reads the delta the dq entry wrote, so it
// runs after it on the same stream. (P, Gt, gchunks) is the tile plan of the
// swept (dk/dv: 64 rows) or owned (dq: 128 rows) q tile. dtype: 0 = bf16,
// 1 = f16. Each entry launches one kernel and returns cudaGetLastError(), or
// one of the negative ERR_ codes above without launching.
extern "C" int flash_attention_bwd_dq_launch(
    const void* q, const void* k, const void* v, const void* o, const void* dout, const float* lse, float* delta,
    void* dq, const long long* s, int B, int KVH, int Sq, int Skv, int G, int D, int P, int Gt, int gchunks,
    int causal, int q_offset, float scale, int dtype, void* stream) {
  DqParams p;
  p.o = o; p.dout = dout; p.lse = lse; p.delta = delta; p.dq = dq;
  p.o_sb = s[10]; p.o_sh = s[11]; p.o_ss = s[12]; p.o_sg = s[13];
  p.do_sb = s[14]; p.do_sh = s[15]; p.do_ss = s[16]; p.do_sg = s[17];
  p.dq_sb = s[18]; p.dq_sh = s[19]; p.dq_ss = s[20]; p.dq_sg = s[21];
  p.KVH = KVH; p.Sq = Sq; p.Skv = Skv; p.G = G;
  p.tp = TilePlan{P, Gt, gchunks};
  p.causal = causal; p.q_offset = q_offset; p.scale = scale;
  if (!plan_ok(p.tp, G, DQ_ROWS)) return ERR_PLAN;
  if (!((D == 64 || D == 112 || D == 128 || D == 160) && (dtype == 0 || dtype == 1))) return ERR_NO_KERNEL;
  CUtensorMap m[4];
  int r;
  if ((r = map_folded(&m[0], q, dtype, s, B, KVH, Sq, G, D, p.tp)) != 0) return r;
  if ((r = map_folded(&m[1], dout, dtype, s + 14, B, KVH, Sq, G, D, p.tp)) != 0) return r;
  const int nk = D == 64    ? dq_kv_rows<64>()
                 : D == 112 ? dq_kv_rows<112>()
                 : D == 128 ? dq_kv_rows<128>()
                            : dq_kv_rows<160>();
  if ((r = map_kv(&m[2], k, dtype, s + 4, B, KVH, Skv, D, nk)) != 0) return r;
  if ((r = map_kv(&m[3], v, dtype, s + 7, B, KVH, Skv, D, nk)) != 0) return r;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && D == 64) return launch_dq<__nv_bfloat16, 64>(m, p, B, st);
  if (dtype == 0 && D == 112) return launch_dq<__nv_bfloat16, 112>(m, p, B, st);
  if (dtype == 0 && D == 128) return launch_dq<__nv_bfloat16, 128>(m, p, B, st);
  if (dtype == 1 && D == 64) return launch_dq<__half, 64>(m, p, B, st);
  if (dtype == 1 && D == 112) return launch_dq<__half, 112>(m, p, B, st);
  if (dtype == 1 && D == 128) return launch_dq<__half, 128>(m, p, B, st);
  if (dtype == 0) return launch_dq<__nv_bfloat16, 160>(m, p, B, st);
  return launch_dq<__half, 160>(m, p, B, st);
}

extern "C" int flash_attention_bwd_dkv_launch(
    const void* q, const void* k, const void* v, const void* dout, const float* lse, const float* delta,
    void* dk, void* dv, const long long* s, int B, int KVH, int Sq, int Skv, int G, int D, int P, int Gt,
    int gchunks, int causal, int q_offset, float scale, int dtype, void* stream) {
  DkvParams p;
  p.lse = lse; p.delta = delta; p.dk = dk; p.dv = dv;
  p.dk_sb = s[14]; p.dk_sh = s[15]; p.dk_ss = s[16];
  p.dv_sb = s[17]; p.dv_sh = s[18]; p.dv_ss = s[19];
  p.KVH = KVH; p.Sq = Sq; p.Skv = Skv; p.G = G;
  p.tp = TilePlan{P, Gt, gchunks};
  p.causal = causal; p.q_offset = q_offset; p.scale = scale;
  if (!plan_ok(p.tp, G, SWEEP_ROWS)) return ERR_PLAN;
  if (!((D == 64 || D == 112 || D == 128 || D == 160) && (dtype == 0 || dtype == 1))) return ERR_NO_KERNEL;
  const int own = D == 64    ? dkv_own_rows<64>()
                  : D == 112 ? dkv_own_rows<112>()
                  : D == 128 ? dkv_own_rows<128>()
                             : dkv_own_rows<160>();
  CUtensorMap m[4];
  int r;
  if ((r = map_folded(&m[0], q, dtype, s, B, KVH, Sq, G, D, p.tp)) != 0) return r;
  if ((r = map_folded(&m[1], dout, dtype, s + 10, B, KVH, Sq, G, D, p.tp)) != 0) return r;
  if ((r = map_kv(&m[2], k, dtype, s + 4, B, KVH, Skv, D, own)) != 0) return r;
  if ((r = map_kv(&m[3], v, dtype, s + 7, B, KVH, Skv, D, own)) != 0) return r;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && D == 64) return launch_dkv<__nv_bfloat16, 64>(m, p, B, st);
  if (dtype == 0 && D == 112) return launch_dkv<__nv_bfloat16, 112>(m, p, B, st);
  if (dtype == 0 && D == 128) return launch_dkv<__nv_bfloat16, 128>(m, p, B, st);
  if (dtype == 1 && D == 64) return launch_dkv<__half, 64>(m, p, B, st);
  if (dtype == 1 && D == 112) return launch_dkv<__half, 112>(m, p, B, st);
  if (dtype == 1 && D == 128) return launch_dkv<__half, 128>(m, p, B, st);
  if (dtype == 0) return launch_dkv<__nv_bfloat16, 160>(m, p, B, st);
  return launch_dkv<__half, 160>(m, p, B, st);
}
