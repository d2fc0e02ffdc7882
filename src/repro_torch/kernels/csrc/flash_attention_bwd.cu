// Causal / full GQA flash-attention backward for Hopper (sm_90a): two kernels.
//
// Replaces the TPU kernels of repro/kernels/flash_attention.py::flash_attention_bwd:
//   * flash_bwd_dkv_kernel <- _bwd_dkv_kernel (first pallas_call, grid B,KVH,nk,nq):
//     for one KV tile, sweep the q tiles: p = exp(s - lse), dv += p^T.do,
//     ds = p o (do.v^T - delta), dk += scale * ds^T.q. The G folded rows of a
//     q tile all meet the same KV head, so summing over rows is what reduces the
//     GQA gradients onto it.
//   * flash_bwd_dq_kernel  <- _bwd_dq_kernel (second pallas_call, grid B,KVH,nq,nk):
//     for one q tile, sweep the KV tiles: the same p and ds, dq += scale * ds.k.
// Both recompute p from q, k and the forward's lse, so no S x S tensor exists.
// delta = sum_d o*do is an input (computed by the wrapper, as the reference
// computes it outside its kernels).
//
// What bounds them on this card: operations. At the training shape
// (q (2,8,4096,4,64), k/v (2,8,4096,64), causal) the dk/dv kernel needs
// 8*D FLOP per live (row, key) pair (s, dv, dp, dk), 275 GFLOP, and the dq
// kernel 6*D (s, dp, dq), 206 GFLOP, against about 100 MB of traffic each: far
// above the card's ~295 FLOP/byte ridge.
//
// What the design does about it: every product runs on the tensor cores
// (mma.sync m16n8k16, bf16 or f16 in, f32 accumulate). The accumulators stay in
// registers for the whole sweep (dk and dv for 16 kv rows a warp in the dk/dv
// kernel, dq for 16 folded rows a warp in the dq kernel), so each kernel writes
// its outputs once, with no atomics and no second pass. The score fragment is
// re-packed in place as the A operand of the next product (p^T.do, ds^T.q,
// ds.k), so p and ds never leave registers. Operands come out of shared memory
// with ldmatrix (transposed where the product needs it) from rows padded so the
// reads hit all banks, and the next tile is fetched with cp.async into a second
// buffer while the current one is multiplied. Blocks are scheduled heaviest
// first (the tile index is the slowest grid axis), and only the tiles on the
// causal diagonal or a ragged edge are masked.
// What they do not do yet: no wgmma and no TMA, a two-stage pipeline only, and
// the dk/dv kernel recomputes s where FlashAttention-2 would share it with dq
// through atomics.
//
// Differences from the TPU kernels, on purpose:
//   * the sequential grid axis of each TPU kernel is a loop inside one block;
//   * tiles are 64 folded rows x 64 kv positions (the TPU default of 512 x 512
//     with G = 4 is 2,048 rows, far beyond one SM);
//   * the causal sweep of the dk/dv kernel starts at the first q tile that
//     reaches its KV tile, and the dq kernel's ends at the diagonal, instead of
//     visiting every tile and skipping the dead ones;
//   * the ragged edges are masked, so any Sq, Skv >= 1 works (the TPU entry
//     needs lengths that divide its blocks);
//   * every tensor is addressed through strides (last dim contiguous), so the
//     (B,S,H,D) -> (B,KVH,S,G,D) fold of q, do and dq is a view;
//   * p and ds are rounded to the input type as tensor-core operands; the
//     softmax algebra stays f32.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <stdint.h>

namespace {

constexpr float LOG2E = 1.4426950408889634f;
constexpr int BM = 64;              // folded (q position, group) rows per tile
constexpr int BN = 64;              // kv positions per tile
constexpr int NWARPS = 4;           // one m16 row slab per warp
constexpr int NTHREADS = NWARPS * 32;
static_assert(BM == BN, "the q and kv tiles share one shared-memory tile size");

struct BwdParams {
  const void* q;
  const void* k;
  const void* v;
  const void* dout;
  const float* lse;    // (B,KVH,Sq,G) contiguous
  const float* delta;  // (B,KVH,Sq,G) contiguous
  void* dq;
  void* dk;
  void* dv;
  long long q_sb, q_sh, q_ss, q_sg;
  long long k_sb, k_sh, k_ss;
  long long v_sb, v_sh, v_ss;
  long long do_sb, do_sh, do_ss, do_sg;
  long long dq_sb, dq_sh, dq_ss, dq_sg;
  long long dk_sb, dk_sh, dk_ss;
  long long dv_sb, dv_sh, dv_ss;
  int B, KVH, Sq, Skv, G;
  int causal, q_offset;
  float scale;
};

template <typename T>
struct TensorOp;

template <>
struct TensorOp<__nv_bfloat16> {
  static __device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                             uint32_t b0, uint32_t b1) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  }
  static __device__ __forceinline__ uint32_t pack(float lo, float hi) {
    __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&h);
  }
};

template <>
struct TensorOp<__half> {
  static __device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                             uint32_t b0, uint32_t b1) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  }
  static __device__ __forceinline__ uint32_t pack(float lo, float hi) {
    __half2 h = __floats2half2_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&h);
  }
};

// Four 8x8 b16 matrices from shared memory: lane l supplies the address of
// row (l & 7) of matrix (l >> 3); register i receives matrix i with thread
// (g, t) holding elements [g][2t] and [g][2t+1].
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* smem_row) {
  uint32_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(smem_row));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// The same with each matrix transposed on the way: thread (g, t) holds
// elements [2t][g] and [2t+1][g] of matrix i.
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* smem_row) {
  uint32_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(smem_row));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// 16 bytes from global to shared memory without passing through registers;
// with ``valid`` false nothing is read and the 16 bytes are zero-filled.
__device__ __forceinline__ void cp_async_16(void* smem_dst, const void* gmem_src, bool valid) {
  const uint32_t dst = static_cast<uint32_t>(__cvta_generic_to_shared(smem_dst));
  const int src_bytes = valid ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(dst), "l"(gmem_src), "r"(src_bytes) : "memory");
}

// The same for one 4-byte word (the per-row f32 statistics).
__device__ __forceinline__ void cp_async_4(void* smem_dst, const void* gmem_src, bool valid) {
  const uint32_t dst = static_cast<uint32_t>(__cvta_generic_to_shared(smem_dst));
  const int src_bytes = valid ? 4 : 0;
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(dst), "l"(gmem_src), "r"(src_bytes) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most the most recently committed group is still in flight
__device__ __forceinline__ void cp_async_wait_all_but_last() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

// The A fragment (16 x 16, row-major) of rows [0, 16) and columns [0, 16) of
// ``base``: lanes 0-15 address rows 0-15 at column 0, lanes 16-31 the same
// rows at column 8, so registers 0-3 are a0-a3 of mma.m16n8k16.
template <typename T>
__device__ __forceinline__ void load_a(uint32_t (&a)[4], const T* base, int ld, int lane) {
  ldmatrix_x4(a, base + (lane & 15) * ld + (lane >> 4) * 8);
}

// acc[16 x 8*NT] += A (16 x D, from ``a_rows`` in shared memory) . Bs^T, where
// Bs holds 8*NT rows of D contiguous elements (row n of Bs is column n of the
// product): q.k^T, do.v^T, k.q^T, v.do^T.
template <typename T, int D, int NT>
__device__ __forceinline__ void mma_abt(float (&acc)[NT][4], const T* a_rows, const T* bs,
                                        int ld, int lane) {
  const int brow = (lane & 7) + (lane >> 4) * 8;
  const int bcol = ((lane >> 3) & 1) * 8;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    uint32_t a[4];
    load_a(a, a_rows + kk * 16, ld, lane);
#pragma unroll
    for (int j = 0; j < NT; j += 2) {
      uint32_t b[4];
      ldmatrix_x4(b, &bs[(j * 8 + brow) * ld + kk * 16 + bcol]);
      TensorOp<T>::mma(acc[j], a, b[0], b[1]);
      TensorOp<T>::mma(acc[j + 1], a, b[2], b[3]);
    }
  }
}

// acc[16 x D] += P (16 x 8*NT, the accumulator fragments of an earlier
// product, rounded to T) . Bs, where Bs holds 8*NT rows of D contiguous
// elements (row k of Bs is row k of the right operand): p^T.do, ds^T.q, ds.k.
template <typename T, int D, int NT>
__device__ __forceinline__ void mma_pb(float (&acc)[D / 8][4], const float (&pf)[NT][4],
                                       const T* bs, int ld, int lane) {
#pragma unroll
  for (int c = 0; c < NT / 2; ++c) {
    uint32_t pa[4];
    pa[0] = TensorOp<T>::pack(pf[2 * c][0], pf[2 * c][1]);
    pa[1] = TensorOp<T>::pack(pf[2 * c][2], pf[2 * c][3]);
    pa[2] = TensorOp<T>::pack(pf[2 * c + 1][0], pf[2 * c + 1][1]);
    pa[3] = TensorOp<T>::pack(pf[2 * c + 1][2], pf[2 * c + 1][3]);
    const int brow = c * 16 + (lane & 7) + ((lane >> 3) & 1) * 8;
#pragma unroll
    for (int n2 = 0; n2 < D / 16; ++n2) {
      uint32_t b[4];
      ldmatrix_x4_trans(b, &bs[brow * ld + n2 * 16 + (lane >> 4) * 8]);
      TensorOp<T>::mma(acc[2 * n2], pa, b[0], b[1]);
      TensorOp<T>::mma(acc[2 * n2 + 1], pa, b[2], b[3]);
    }
  }
}

template <int N>
__device__ __forceinline__ void zero(float (&x)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i) {
    x[i][0] = 0.f; x[i][1] = 0.f; x[i][2] = 0.f; x[i][3] = 0.f;
  }
}

// One row of D/8 accumulator fragments (elements lo, lo + 1 of each), times
// ``scale``, to a row of T with 4-byte stores.
template <typename T, int D>
__device__ __forceinline__ void store_row(T* row, const float (&acc)[D / 8][4], int lo,
                                          float scale, int t) {
#pragma unroll
  for (int n = 0; n < D / 8; ++n) {
    *reinterpret_cast<uint32_t*>(row + n * 8 + 2 * t) =
        TensorOp<T>::pack(acc[n][lo] * scale, acc[n][lo + 1] * scale);
  }
}

// ---------------------------------------------------------------------------
// dq: one block per (q tile, kv head, batch); sweeps the KV tiles
// ---------------------------------------------------------------------------

template <typename T, int D>
__global__ void __launch_bounds__(NTHREADS) flash_bwd_dq_kernel(const BwdParams p) {
  constexpr int LD = D + 8;   // padded smem row: 16-byte chunks of 8 rows hit 8 bank groups
  constexpr int CH = D / 8;   // 16-byte chunks per row
  constexpr int NT = BN / 8;  // n tiles of a score slab
  constexpr int TILE = BN * LD;

  // two stages of (K tile, V tile); stage 0 first stages the q and do tiles
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* const smem = reinterpret_cast<T*>(smem_raw);

  // heaviest (latest) causal tiles first: the tile is the slowest grid axis
  const int tile = gridDim.z - 1 - blockIdx.z;
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;  // fragment row within the slab (and row + 8)
  const int t = lane & 3;   // fragment column pair

  const int rows_total = p.Sq * p.G;
  const int row0 = tile * BM;

  const T* qb = static_cast<const T*>(p.q) + b * p.q_sb + h * p.q_sh;
  const T* kb = static_cast<const T*>(p.k) + b * p.k_sb + h * p.k_sh;
  const T* vb = static_cast<const T*>(p.v) + b * p.v_sb + h * p.v_sh;
  const T* dob = static_cast<const T*>(p.dout) + b * p.do_sb + h * p.do_sh;
  T* dqb = static_cast<T*>(p.dq) + b * p.dq_sb + h * p.dq_sh;
  const long long stat0 = (static_cast<long long>(b) * p.KVH + h) * rows_total;

  // ---- q and do tiles: staged through stage 0 for 16-byte coalesced loads,
  // then held as A fragments in registers for the whole KV sweep
  for (int i = tid; i < BM * CH; i += NTHREADS) {
    const int r = i / CH;
    const int c = i % CH;
    const int row = row0 + r;
    uint4 qv = make_uint4(0u, 0u, 0u, 0u);
    uint4 dv = make_uint4(0u, 0u, 0u, 0u);
    if (row < rows_total) {
      const long long qi = row / p.G;
      const long long gi = row % p.G;
      qv = *reinterpret_cast<const uint4*>(qb + qi * p.q_ss + gi * p.q_sg + c * 8);
      dv = *reinterpret_cast<const uint4*>(dob + qi * p.do_ss + gi * p.do_sg + c * 8);
    }
    *reinterpret_cast<uint4*>(&smem[r * LD + c * 8]) = qv;
    *reinterpret_cast<uint4*>(&smem[TILE + r * LD + c * 8]) = dv;
  }
  __syncthreads();
  uint32_t qf[D / 16][4], df[D / 16][4];
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    load_a(qf[kk], smem + warp * 16 * LD + kk * 16, LD, lane);
    load_a(df[kk], smem + TILE + warp * 16 * LD + kk * 16, LD, lane);
  }
  __syncthreads();

  const int row_a = row0 + warp * 16 + g;  // this thread's two rows
  const int row_b = row_a + 8;
  const int qpos_a = p.q_offset + row_a / p.G;
  const int qpos_b = p.q_offset + row_b / p.G;
  const float c2 = p.scale * LOG2E;  // exp(scale * s - lse) = exp2(c2 * s - lse * log2(e))
  const float nl_a = row_a < rows_total ? -p.lse[stat0 + row_a] * LOG2E : 0.f;
  const float nl_b = row_b < rows_total ? -p.lse[stat0 + row_b] * LOG2E : 0.f;
  const float dl_a = row_a < rows_total ? p.delta[stat0 + row_a] : 0.f;
  const float dl_b = row_b < rows_total ? p.delta[stat0 + row_b] : 0.f;

  float dq[D / 8][4];
  zero(dq);

  // causal: KV tiles wholly above the diagonal of this block are never visited
  int kv_end = p.Skv;
  if (p.causal) {
    const int last_row = min(row0 + BM, rows_total) - 1;
    kv_end = min(p.Skv, p.q_offset + last_row / p.G + 1);
  }
  const int n_tiles = kv_end > 0 ? (kv_end + BN - 1) / BN : 0;

  auto fetch = [&](int it) {
    T* dK = smem + (it & 1) * 2 * TILE;
    T* dV = dK + TILE;
    const int kv0 = it * BN;
    for (int i = tid; i < BN * CH; i += NTHREADS) {
      const int r = i / CH;
      const int c = i % CH;
      const bool in = kv0 + r < p.Skv;
      const long long kv = in ? kv0 + r : 0;
      cp_async_16(&dK[r * LD + c * 8], kb + kv * p.k_ss + c * 8, in);
      cp_async_16(&dV[r * LD + c * 8], vb + kv * p.v_ss + c * 8, in);
    }
  };

  if (n_tiles > 0) fetch(0);
  cp_async_commit();

  for (int it = 0; it < n_tiles; ++it) {
    const int kv0 = it * BN;
    const T* sK = smem + (it & 1) * 2 * TILE;
    const T* sV = sK + TILE;
    if (it + 1 < n_tiles) fetch(it + 1);
    cp_async_commit();
    cp_async_wait_all_but_last();
    __syncthreads();

    // s = q.k^T and dp = do.v^T, 16 x BN per warp; q and do from registers
    float s[NT][4], dp[NT][4];
    zero(s);
    zero(dp);
    const int brow = (lane & 7) + (lane >> 4) * 8;
    const int bcol = ((lane >> 3) & 1) * 8;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
#pragma unroll
      for (int j = 0; j < NT; j += 2) {
        uint32_t kf[4], vf[4];
        ldmatrix_x4(kf, &sK[(j * 8 + brow) * LD + kk * 16 + bcol]);
        TensorOp<T>::mma(s[j], qf[kk], kf[0], kf[1]);
        TensorOp<T>::mma(s[j + 1], qf[kk], kf[2], kf[3]);
        ldmatrix_x4(vf, &sV[(j * 8 + brow) * LD + kk * 16 + bcol]);
        TensorOp<T>::mma(dp[j], df[kk], vf[0], vf[1]);
        TensorOp<T>::mma(dp[j + 1], df[kk], vf[2], vf[3]);
      }
    }

    // p = exp(scale * s - lse), masked to 0 where this tile needs it; ds = p o (dp - delta)
    const bool tile_masked =
        (kv0 + BN > p.Skv) || (p.causal && kv0 + BN - 1 > p.q_offset + row0 / p.G);
#pragma unroll
    for (int j = 0; j < NT; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float pv = exp2f(fmaf(s[j][e], c2, e < 2 ? nl_a : nl_b));
        if (tile_masked) {
          const int col = kv0 + j * 8 + 2 * t + (e & 1);
          const int qpos = e < 2 ? qpos_a : qpos_b;
          pv = (col < p.Skv && (!p.causal || qpos >= col)) ? pv : 0.f;
        }
        s[j][e] = pv * (dp[j][e] - (e < 2 ? dl_a : dl_b));
      }
    }

    // dq += ds.k
    mma_pb<T, D, NT>(dq, s, sK, LD, lane);
    __syncthreads();
  }

  if (row_a < rows_total) {
    store_row<T, D>(dqb + static_cast<long long>(row_a / p.G) * p.dq_ss +
                        static_cast<long long>(row_a % p.G) * p.dq_sg,
                    dq, 0, p.scale, t);
  }
  if (row_b < rows_total) {
    store_row<T, D>(dqb + static_cast<long long>(row_b / p.G) * p.dq_ss +
                        static_cast<long long>(row_b % p.G) * p.dq_sg,
                    dq, 2, p.scale, t);
  }
}

// ---------------------------------------------------------------------------
// dk, dv: one block per (kv tile, kv head, batch); sweeps the q tiles
// ---------------------------------------------------------------------------

template <typename T, int D>
__global__ void __launch_bounds__(NTHREADS) flash_bwd_dkv_kernel(const BwdParams p) {
  constexpr int LD = D + 8;
  constexpr int CH = D / 8;
  constexpr int NT = BM / 8;  // n tiles of a transposed score slab (folded rows)
  constexpr int TILE = BM * LD;

  // K tile, V tile, then two stages of (q tile, do tile), then two stages of
  // (lse, delta) for the BM rows of a q tile
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* const smem = reinterpret_cast<T*>(smem_raw);
  T* const sK = smem;
  T* const sV = smem + TILE;
  float* const stats = reinterpret_cast<float*>(smem + 6 * TILE);

  // heaviest first: under the causal mask KV tile 0 meets every q tile
  const int kt = blockIdx.z;
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int t = lane & 3;

  const int rows_total = p.Sq * p.G;
  const int kv0 = kt * BN;
  const int kv_a = kv0 + warp * 16 + g;  // this thread's two kv rows
  const int kv_b = kv_a + 8;

  const T* qb = static_cast<const T*>(p.q) + b * p.q_sb + h * p.q_sh;
  const T* kb = static_cast<const T*>(p.k) + b * p.k_sb + h * p.k_sh;
  const T* vb = static_cast<const T*>(p.v) + b * p.v_sb + h * p.v_sh;
  const T* dob = static_cast<const T*>(p.dout) + b * p.do_sb + h * p.do_sh;
  T* dkb = static_cast<T*>(p.dk) + b * p.dk_sb + h * p.dk_sh;
  T* dvb = static_cast<T*>(p.dv) + b * p.dv_sb + h * p.dv_sh;
  const long long stat0 = (static_cast<long long>(b) * p.KVH + h) * rows_total;

  // causal: the first folded row whose position reaches kv0 is (kv0 - q_offset) * G
  long long r_begin = 0;
  if (p.causal && kv0 > p.q_offset) r_begin = static_cast<long long>(kv0 - p.q_offset) * p.G;
  const int n_qt = (rows_total + BM - 1) / BM;
  const int tile_begin = r_begin >= rows_total ? n_qt : static_cast<int>(r_begin / BM);
  const int n_iter = n_qt - tile_begin;

  float dk[D / 8][4], dv[D / 8][4];
  zero(dk);
  zero(dv);

  auto fetch = [&](int it) {
    T* sQ = smem + (2 + 2 * (it & 1)) * TILE;
    T* sD = sQ + TILE;
    float* sL = stats + (it & 1) * 2 * BM;
    const int r0 = (tile_begin + it) * BM;
    for (int i = tid; i < BM * CH; i += NTHREADS) {
      const int r = i / CH;
      const int c = i % CH;
      const int row = r0 + r;
      const bool in = row < rows_total;
      const long long qi = in ? row / p.G : 0;
      const long long gi = in ? row % p.G : 0;
      cp_async_16(&sQ[r * LD + c * 8], qb + qi * p.q_ss + gi * p.q_sg + c * 8, in);
      cp_async_16(&sD[r * LD + c * 8], dob + qi * p.do_ss + gi * p.do_sg + c * 8, in);
    }
    if (tid < BM) {
      const int row = r0 + tid;
      const bool in = row < rows_total;
      const long long at = stat0 + (in ? row : 0);
      cp_async_4(&sL[tid], p.lse + at, in);
      cp_async_4(&sL[BM + tid], p.delta + at, in);
    }
  };

  if (n_iter > 0) {
    // the K and V tiles, read once, travel with the first q tile
    for (int i = tid; i < BN * CH; i += NTHREADS) {
      const int r = i / CH;
      const int c = i % CH;
      const bool in = kv0 + r < p.Skv;
      const long long kv = in ? kv0 + r : 0;
      cp_async_16(&sK[r * LD + c * 8], kb + kv * p.k_ss + c * 8, in);
      cp_async_16(&sV[r * LD + c * 8], vb + kv * p.v_ss + c * 8, in);
    }
    fetch(0);
  }
  cp_async_commit();

  const float c2 = p.scale * LOG2E;
  const T* const k_rows = sK + warp * 16 * LD;
  const T* const v_rows = sV + warp * 16 * LD;

  for (int it = 0; it < n_iter; ++it) {
    const T* sQ = smem + (2 + 2 * (it & 1)) * TILE;
    const T* sD = sQ + TILE;
    const float* sL = stats + (it & 1) * 2 * BM;
    const float* sDelta = sL + BM;
    const int r0 = (tile_begin + it) * BM;
    if (it + 1 < n_iter) fetch(it + 1);
    cp_async_commit();
    cp_async_wait_all_but_last();
    __syncthreads();

    // s^T = k.q^T: 16 kv rows x BM folded rows per warp
    float s[NT][4];
    zero(s);
    mma_abt<T, D, NT>(s, k_rows, sQ, LD, lane);

    // p^T = exp(scale * s^T - lse), masked to 0 where this tile needs it
    const bool tile_masked = (r0 + BM > rows_total) || (kv0 + BN > p.Skv) ||
                             (p.causal && p.q_offset + r0 / p.G < kv0 + BN - 1);
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const int cl = j * 8 + 2 * t;
      const float nl0 = -sL[cl] * LOG2E;
      const float nl1 = -sL[cl + 1] * LOG2E;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float pv = exp2f(fmaf(s[j][e], c2, (e & 1) ? nl1 : nl0));
        if (tile_masked) {
          const int row = r0 + cl + (e & 1);
          const int kv = e < 2 ? kv_a : kv_b;
          const bool ok = row < rows_total && kv < p.Skv &&
                          (!p.causal || p.q_offset + row / p.G >= kv);
          pv = ok ? pv : 0.f;
        }
        s[j][e] = pv;
      }
    }

    // dv += p^T.do
    mma_pb<T, D, NT>(dv, s, sD, LD, lane);

    // dp^T = v.do^T, then ds^T = p^T o (dp^T - delta)
    float dp[NT][4];
    zero(dp);
    mma_abt<T, D, NT>(dp, v_rows, sD, LD, lane);
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const int cl = j * 8 + 2 * t;
      const float d0 = sDelta[cl];
      const float d1 = sDelta[cl + 1];
      s[j][0] *= dp[j][0] - d0;
      s[j][1] *= dp[j][1] - d1;
      s[j][2] *= dp[j][2] - d0;
      s[j][3] *= dp[j][3] - d1;
    }

    // dk += ds^T.q (times scale at the end)
    mma_pb<T, D, NT>(dk, s, sQ, LD, lane);
    __syncthreads();
  }

  if (kv_a < p.Skv) {
    store_row<T, D>(dkb + static_cast<long long>(kv_a) * p.dk_ss, dk, 0, p.scale, t);
    store_row<T, D>(dvb + static_cast<long long>(kv_a) * p.dv_ss, dv, 0, 1.f, t);
  }
  if (kv_b < p.Skv) {
    store_row<T, D>(dkb + static_cast<long long>(kv_b) * p.dk_ss, dk, 2, p.scale, t);
    store_row<T, D>(dvb + static_cast<long long>(kv_b) * p.dv_ss, dv, 2, 1.f, t);
  }
}

template <typename T, int D>
int launch_dq(const BwdParams& p, cudaStream_t stream) {
  const int rows_total = p.Sq * p.G;
  // 2 stages x (K, V) x BN rows of D + 8: 36 KB at D = 64, 68 KB at D = 128
  const int smem_bytes = 2 * 2 * BN * (D + 8) * static_cast<int>(sizeof(T));
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dq_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid(p.KVH, p.B, (rows_total + BM - 1) / BM);
  flash_bwd_dq_kernel<T, D><<<grid, NTHREADS, smem_bytes, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int D>
int launch_dkv(const BwdParams& p, cudaStream_t stream) {
  // (K, V) + 2 stages x (q, do), each BM rows of D + 8, and 2 x (lse, delta)
  // of BM floats: 55 KB at D = 64, 103 KB at D = 128
  const int smem_bytes =
      6 * BM * (D + 8) * static_cast<int>(sizeof(T)) + 4 * BM * static_cast<int>(sizeof(float));
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dkv_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid(p.KVH, p.B, (p.Skv + BN - 1) / BN);
  flash_bwd_dkv_kernel<T, D><<<grid, NTHREADS, smem_bytes, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

BwdParams make_params(const void* q, const void* k, const void* v, const void* dout,
                      const float* lse, const float* delta, void* dq, void* dk, void* dv,
                      const long long* s, int B, int KVH, int Sq, int Skv, int G,
                      int causal, int q_offset, float scale) {
  BwdParams p;
  p.q = q; p.k = k; p.v = v; p.dout = dout; p.lse = lse; p.delta = delta;
  p.dq = dq; p.dk = dk; p.dv = dv;
  p.q_sb = s[0]; p.q_sh = s[1]; p.q_ss = s[2]; p.q_sg = s[3];
  p.k_sb = s[4]; p.k_sh = s[5]; p.k_ss = s[6];
  p.v_sb = s[7]; p.v_sh = s[8]; p.v_ss = s[9];
  p.do_sb = s[10]; p.do_sh = s[11]; p.do_ss = s[12]; p.do_sg = s[13];
  p.dq_sb = s[14]; p.dq_sh = s[15]; p.dq_ss = s[16]; p.dq_sg = s[17];
  p.dk_sb = s[18]; p.dk_sh = s[19]; p.dk_ss = s[20];
  p.dv_sb = s[21]; p.dv_sh = s[22]; p.dv_ss = s[23];
  p.B = B; p.KVH = KVH; p.Sq = Sq; p.Skv = Skv; p.G = G;
  p.causal = causal; p.q_offset = q_offset; p.scale = scale;
  return p;
}

}  // namespace

// strides (in elements): q b,kvh,s,g | k b,kvh,s | v b,kvh,s | do b,kvh,s,g |
// dq b,kvh,s,g | dk b,kvh,s | dv b,kvh,s. dtype: 0 = bf16, 1 = f16. Each entry
// launches one kernel and returns cudaGetLastError(), or -1 for a head_dim or
// type that has no instantiation. The dq entry leaves dk, dv untouched and the
// dk/dv entry dq.
extern "C" int flash_attention_bwd_dq_launch(
    const void* q, const void* k, const void* v, const void* dout, const float* lse,
    const float* delta, void* dq, const long long* strides, int B, int KVH, int Sq,
    int Skv, int G, int D, int causal, int q_offset, float scale, int dtype, void* stream) {
  const BwdParams p = make_params(q, k, v, dout, lse, delta, dq, nullptr, nullptr, strides,
                                  B, KVH, Sq, Skv, G, causal, q_offset, scale);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && D == 64) return launch_dq<__nv_bfloat16, 64>(p, st);
  if (dtype == 0 && D == 128) return launch_dq<__nv_bfloat16, 128>(p, st);
  if (dtype == 1 && D == 64) return launch_dq<__half, 64>(p, st);
  if (dtype == 1 && D == 128) return launch_dq<__half, 128>(p, st);
  return -1;
}

extern "C" int flash_attention_bwd_dkv_launch(
    const void* q, const void* k, const void* v, const void* dout, const float* lse,
    const float* delta, void* dk, void* dv, const long long* strides, int B, int KVH, int Sq,
    int Skv, int G, int D, int causal, int q_offset, float scale, int dtype, void* stream) {
  const BwdParams p = make_params(q, k, v, dout, lse, delta, nullptr, dk, dv, strides,
                                  B, KVH, Sq, Skv, G, causal, q_offset, scale);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && D == 64) return launch_dkv<__nv_bfloat16, 64>(p, st);
  if (dtype == 0 && D == 128) return launch_dkv<__nv_bfloat16, 128>(p, st);
  if (dtype == 1 && D == 64) return launch_dkv<__half, 64>(p, st);
  if (dtype == 1 && D == 128) return launch_dkv<__half, 128>(p, st);
  return -1;
}
