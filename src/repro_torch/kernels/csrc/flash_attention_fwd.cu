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
// card's ~295 FLOP/byte ridge, so the tensor cores are the limit.
//
// What the design does about it: both products run on the tensor cores
// (mma.sync m16n8k16, bf16 or f16 in, f32 accumulate); the scores never leave
// registers, because the accumulator fragment of q.k^T is re-packed in place
// as the A fragment of p.v; K and V tiles are read once per block of 64 folded
// rows, which at G=4 is 16 query positions x 4 heads sharing one K/V tile;
// K and V fragments come out of shared memory with ldmatrix, four 8x8
// matrices an instruction, from rows padded so that the reads hit all banks.
// The next K/V tile is fetched with cp.async into a second buffer while the
// current one is multiplied. Only the tiles on the causal diagonal or the
// ragged edge are masked, and scale and log2(e) are folded into the one FMA in
// front of ex2.
// What it does not do yet: no wgmma and no TMA, a two-stage pipeline only, and
// o is written with 4-byte stores straight from the fragments.
//
// Differences from the TPU kernel, on purpose:
//   * the TPU grid's sequential KV axis is a loop inside one block, and m, l
//     are per-row registers, not lane-replicated (rows, 128) tiles;
//   * tiles are 64 folded rows x 64 kv positions (the TPU default of 512x512
//     with G=4 is 2048 accumulator rows, far beyond one SM);
//   * the ragged edge is masked, so any Sq, Skv >= 1 works;
//   * q, k, v, o are addressed through strides (last dim contiguous), so the
//     (B,S,H,D) -> (B,KVH,S,G,D) fold is a view and costs no copy;
//   * p is rounded to the input type for p.v (tensor-core operand); softmax
//     statistics stay f32.
// Kept from the TPU kernel: the finite mask value -1e30 and the guarded final
// divide max(l, 1e-30), so a fully masked row gives the same numbers, not NaN.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <stdint.h>

namespace {

constexpr float NEG_INF = -1e30f;
constexpr int BM = 64;              // folded (q position, group) rows per block
constexpr int BN = 64;              // kv positions per tile
constexpr int NWARPS = BM / 16;     // one m16 row slab per warp
constexpr int NTHREADS = NWARPS * 32;

struct FlashParams {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  float* lse;
  long long q_sb, q_sh, q_ss, q_sg;
  long long k_sb, k_sh, k_ss;
  long long v_sb, v_sh, v_ss;
  long long o_sb, o_sh, o_ss, o_sg;
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

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most the most recently committed group is still in flight
__device__ __forceinline__ void cp_async_wait_all_but_last() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
  return x;
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  x += __shfl_xor_sync(0xffffffffu, x, 2);
  return x;
}

// The row max in score units. A row that saw nothing but masked slots keeps
// the mask value itself, as in the TPU kernel, where the mask is applied
// after scaling.
__device__ __forceinline__ float scaled_max(float m_raw, float scale) {
  return m_raw == NEG_INF ? NEG_INF : m_raw * scale;
}

template <typename T, int D>
__global__ void __launch_bounds__(NTHREADS) flash_fwd_kernel(const FlashParams p) {
  constexpr int LD = D + 8;   // padded smem row: 16-byte chunks of 8 rows hit 8 bank groups
  constexpr int CH = D / 8;   // 16-byte chunks per row
  constexpr int KT = D / 16;  // k tiles of q.k^T
  constexpr int NT = BN / 8;  // n tiles of the score slab
  constexpr int DT = D / 8;   // n tiles of the output slab

  // two stages of (K tile, V tile): tile i+1 is fetched while tile i is used
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* const smem = reinterpret_cast<T*>(smem_raw);
  constexpr int TILE = BN * LD;
  T* sK = smem;  // stage 0; also the staging buffer of the q tile

  // heaviest (latest) causal tiles first
  const int tile = gridDim.x - 1 - blockIdx.x;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
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
  T* ob = static_cast<T*>(p.o) + b * p.o_sb + h * p.o_sh;

  // ---- q tile: staged through sK for 16-byte coalesced loads, then held as
  // A fragments in registers for the whole KV sweep
  for (int i = tid; i < BM * CH; i += NTHREADS) {
    const int r = i / CH;
    const int c = i % CH;
    const int row = row0 + r;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (row < rows_total) {
      const long long qi = row / p.G;
      const long long gi = row % p.G;
      val = *reinterpret_cast<const uint4*>(qb + qi * p.q_ss + gi * p.q_sg + c * 8);
    }
    *reinterpret_cast<uint4*>(&sK[r * LD + c * 8]) = val;
  }
  __syncthreads();

  uint32_t qf[KT][4];
  {
    const T* base = sK + (warp * 16) * LD;
#pragma unroll
    for (int kk = 0; kk < KT; ++kk) {
      qf[kk][0] = *reinterpret_cast<const uint32_t*>(&base[g * LD + kk * 16 + 2 * t]);
      qf[kk][1] = *reinterpret_cast<const uint32_t*>(&base[(g + 8) * LD + kk * 16 + 2 * t]);
      qf[kk][2] = *reinterpret_cast<const uint32_t*>(&base[g * LD + kk * 16 + 8 + 2 * t]);
      qf[kk][3] = *reinterpret_cast<const uint32_t*>(&base[(g + 8) * LD + kk * 16 + 8 + 2 * t]);
    }
  }
  __syncthreads();

  const int row_a = row0 + warp * 16 + g;  // this thread's two rows
  const int row_b = row_a + 8;
  const int qpos_a = p.q_offset + row_a / p.G;
  const int qpos_b = p.q_offset + row_b / p.G;

  float o_acc[DT][4];
#pragma unroll
  for (int n = 0; n < DT; ++n) {
    o_acc[n][0] = 0.f; o_acc[n][1] = 0.f; o_acc[n][2] = 0.f; o_acc[n][3] = 0.f;
  }
  float m_a = NEG_INF, m_b = NEG_INF;  // running max of the unscaled scores
  const float c2 = p.scale * 1.4426950408889634f;  // exp(scale * x) = exp2(c2 * x)
  float l_a = 0.f, l_b = 0.f;  // per-thread partial row sums, reduced over the quad at the end

  // causal: KV tiles wholly above the diagonal of this block are never visited
  int kv_end = p.Skv;
  if (p.causal) {
    const int last_row = min(row0 + BM, rows_total) - 1;
    const int q_hi = p.q_offset + last_row / p.G;
    kv_end = min(p.Skv, q_hi + 1);
  }
  const int n_tiles = kv_end > 0 ? (kv_end + BN - 1) / BN : 0;

  // each thread copies its share of a K tile and a V tile, 16 bytes a time,
  // straight into shared memory; rows past Skv are zero-filled (src size 0)
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
    sK = smem + (it & 1) * 2 * TILE;
    const T* sV = sK + TILE;

    // start the next tile into the other stage (free since the barrier that
    // ended the last iteration), then wait for this one
    if (it + 1 < n_tiles) fetch(it + 1);
    cp_async_commit();
    cp_async_wait_all_but_last();
    __syncthreads();

    // ---- s = q . k^T  (16 x BN per warp)
    float s[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      s[j][0] = 0.f; s[j][1] = 0.f; s[j][2] = 0.f; s[j][3] = 0.f;
    }
    // K is read as B fragments four 8x8 matrices at a time: n tiles j, j+1,
    // each with the two 8-wide halves of the 16-deep k step
    const int krow = (lane & 7) + (lane >> 4) * 8;
    const int kcol = ((lane >> 3) & 1) * 8;
#pragma unroll
    for (int kk = 0; kk < KT; ++kk) {
#pragma unroll
      for (int j = 0; j < NT; j += 2) {
        uint32_t kf[4];
        ldmatrix_x4(kf, &sK[(j * 8 + krow) * LD + kk * 16 + kcol]);
        TensorOp<T>::mma(s[j], qf[kk], kf[0], kf[1]);
        TensorOp<T>::mma(s[j + 1], qf[kk], kf[2], kf[3]);
      }
    }

    // ---- mask (ragged kv edge and causal) where this tile needs it, running
    // max. Scores stay unscaled: scale and log2(e) are folded into the one FMA
    // in front of ex2, so m is the max of the raw dots.
    const bool tile_masked =
        (kv0 + BN > p.Skv) || (p.causal && kv0 + BN - 1 > p.q_offset + row0 / p.G);
    if (tile_masked) {
#pragma unroll
      for (int j = 0; j < NT; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = kv0 + j * 8 + 2 * t + (e & 1);
          const int qpos = (e < 2) ? qpos_a : qpos_b;
          const bool ok = (col < p.Skv) && (!p.causal || qpos >= col);
          s[j][e] = ok ? s[j][e] : NEG_INF;
        }
      }
    }
    float mx_a = NEG_INF, mx_b = NEG_INF;
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      mx_a = fmaxf(mx_a, fmaxf(s[j][0], s[j][1]));
      mx_b = fmaxf(mx_b, fmaxf(s[j][2], s[j][3]));
    }
    mx_a = quad_max(mx_a);
    mx_b = quad_max(mx_b);
    const float mn_a = fmaxf(m_a, mx_a);
    const float mn_b = fmaxf(m_b, mx_b);
    const float corr_a = exp2f((m_a - mn_a) * c2);
    const float corr_b = exp2f((m_b - mn_b) * c2);
    m_a = mn_a;
    m_b = mn_b;
    // p = exp2(c * s + off). A row with nothing valid so far (max still the
    // mask value) takes c = off = 0, so p = 1 on its masked slots as in the
    // TPU kernel's exp(s - m), instead of the difference of two huge products.
    const float c_a = mn_a == NEG_INF ? 0.f : c2;
    const float c_b = mn_b == NEG_INF ? 0.f : c2;
    const float off_a = -mn_a * c_a;
    const float off_b = -mn_b * c_b;

    float sum_a = 0.f, sum_b = 0.f;
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      s[j][0] = exp2f(fmaf(s[j][0], c_a, off_a));
      s[j][1] = exp2f(fmaf(s[j][1], c_a, off_a));
      s[j][2] = exp2f(fmaf(s[j][2], c_b, off_b));
      s[j][3] = exp2f(fmaf(s[j][3], c_b, off_b));
      sum_a += s[j][0] + s[j][1];
      sum_b += s[j][2] + s[j][3];
    }
    l_a = l_a * corr_a + sum_a;
    l_b = l_b * corr_b + sum_b;
#pragma unroll
    for (int n = 0; n < DT; ++n) {
      o_acc[n][0] *= corr_a; o_acc[n][1] *= corr_a;
      o_acc[n][2] *= corr_b; o_acc[n][3] *= corr_b;
    }

    // ---- o += p . v : the score accumulators of two n tiles are the A
    // fragment of one 16-deep k step
#pragma unroll
    for (int c = 0; c < BN / 16; ++c) {
      uint32_t pa[4];
      pa[0] = TensorOp<T>::pack(s[2 * c][0], s[2 * c][1]);
      pa[1] = TensorOp<T>::pack(s[2 * c][2], s[2 * c][3]);
      pa[2] = TensorOp<T>::pack(s[2 * c + 1][0], s[2 * c + 1][1]);
      pa[3] = TensorOp<T>::pack(s[2 * c + 1][2], s[2 * c + 1][3]);
      const int vrow = c * 16 + (lane & 7) + ((lane >> 3) & 1) * 8;
#pragma unroll
      for (int n2 = 0; n2 < D / 16; ++n2) {
        uint32_t vf[4];
        ldmatrix_x4_trans(vf, &sV[vrow * LD + n2 * 16 + (lane >> 4) * 8]);
        TensorOp<T>::mma(o_acc[2 * n2], pa, vf[0], vf[1]);
        TensorOp<T>::mma(o_acc[2 * n2 + 1], pa, vf[2], vf[3]);
      }
    }
    __syncthreads();
  }

  // ---- finalize: o = acc / max(l, 1e-30), lse = m + log(max(l, 1e-30))
  l_a = fmaxf(quad_sum(l_a), 1e-30f);
  l_b = fmaxf(quad_sum(l_b), 1e-30f);
  const float inv_a = 1.f / l_a;
  const float inv_b = 1.f / l_b;
  float* lse_base = p.lse + (static_cast<long long>(b) * p.KVH + h) * rows_total;

  if (row_a < rows_total) {
    T* orow = ob + static_cast<long long>(row_a / p.G) * p.o_ss +
              static_cast<long long>(row_a % p.G) * p.o_sg;
#pragma unroll
    for (int n = 0; n < DT; ++n) {
      *reinterpret_cast<uint32_t*>(orow + n * 8 + 2 * t) =
          TensorOp<T>::pack(o_acc[n][0] * inv_a, o_acc[n][1] * inv_a);
    }
    if (t == 0) lse_base[row_a] = scaled_max(m_a, p.scale) + __logf(l_a);
  }
  if (row_b < rows_total) {
    T* orow = ob + static_cast<long long>(row_b / p.G) * p.o_ss +
              static_cast<long long>(row_b % p.G) * p.o_sg;
#pragma unroll
    for (int n = 0; n < DT; ++n) {
      *reinterpret_cast<uint32_t*>(orow + n * 8 + 2 * t) =
          TensorOp<T>::pack(o_acc[n][2] * inv_b, o_acc[n][3] * inv_b);
    }
    if (t == 0) lse_base[row_b] = scaled_max(m_b, p.scale) + __logf(l_b);
  }
}

template <typename T, int D>
int launch(const FlashParams& p, cudaStream_t stream) {
  const int rows_total = p.Sq * p.G;
  dim3 grid((rows_total + BM - 1) / BM, p.KVH, p.B);
  // 2 stages x (K, V) x BN rows of D + 8: 36 KB at D = 64, 68 KB at D = 128,
  // the latter above the 48 KB a kernel gets without asking
  const int smem_bytes = 2 * 2 * BN * (D + 8) * static_cast<int>(sizeof(T));
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  flash_fwd_kernel<T, D><<<grid, NTHREADS, smem_bytes, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// strides (in elements): q b,kvh,s,g | k b,kvh,s | v b,kvh,s | o b,kvh,s,g.
// dtype: 0 = bf16, 1 = f16. Returns cudaGetLastError(), or -1 for a head_dim or
// type that has no instantiation.
extern "C" int flash_attention_fwd_launch(
    const void* q, const void* k, const void* v, void* o, float* lse,
    const long long* strides, int B, int KVH, int Sq, int Skv, int G, int D,
    int causal, int q_offset, float scale, int dtype, void* stream) {
  FlashParams p;
  p.q = q; p.k = k; p.v = v; p.o = o; p.lse = lse;
  p.q_sb = strides[0]; p.q_sh = strides[1]; p.q_ss = strides[2]; p.q_sg = strides[3];
  p.k_sb = strides[4]; p.k_sh = strides[5]; p.k_ss = strides[6];
  p.v_sb = strides[7]; p.v_sh = strides[8]; p.v_ss = strides[9];
  p.o_sb = strides[10]; p.o_sh = strides[11]; p.o_ss = strides[12]; p.o_sg = strides[13];
  p.B = B; p.KVH = KVH; p.Sq = Sq; p.Skv = Skv; p.G = G;
  p.causal = causal; p.q_offset = q_offset; p.scale = scale;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && D == 64) return launch<__nv_bfloat16, 64>(p, st);
  if (dtype == 0 && D == 128) return launch<__nv_bfloat16, 128>(p, st);
  if (dtype == 1 && D == 64) return launch<__half, 64>(p, st);
  if (dtype == 1 && D == 128) return launch<__half, 128>(p, st);
  return -1;
}
