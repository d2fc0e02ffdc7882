// Single-query decode attention over a KV cache for Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/decode_attention.py::_decode_kernel
// (entry decode_attention). Same function: one new query token per sequence,
// q (B,H,D), against caches (B,Smax,KVH,D) (sequence before heads, read in
// place: no transpose, no copy), online softmax over the first kv_len cache
// slots, out (B,H,D) in q's type. kv_len is one int32 on the device, read by
// the kernel, so a new length needs no host sync and no rebuild.
//
// What bounds it on this card: bytes. Each cache element is used for 2*G
// FLOPs (G = 4 at the serving shape), far below the ~295 FLOP/byte ridge; the
// least time is the bytes of K and V up to kv_len over the memory rate.
//
// What the design does about it:
//   * the cache streams in by TMA: tiles of 64 rows of one (batch, kv head),
//     which lie KVH*D elements apart in the cache, are gathered by the
//     hardware through a 4-D tensor map (D, KVH, Smax, B) into a ring of
//     STAGES buffers behind mbarriers, in the 128-byte swizzle. No register
//     holds a load in flight;
//   * the arithmetic runs on the tensor cores, so that it hides behind the
//     stream: each warp takes 16 rows of a tile, s = q.k^T and o += p.v are
//     mma.sync m16n8k16 (bf16 or f16 in, f32 accumulate) with the block's 8
//     query heads as the rows of the 16-row tiles (the other 8 are padding,
//     and cost nothing the stream would not hide). K and V come out of
//     shared memory by ldmatrix (V transposed), and the online softmax is
//     one exp2 an element;
//   * p keeps f32 precision in p.v, as in the TPU kernel: it goes to the A
//     fragments of PARTS products, each part the 16-bit rounding of what the
//     earlier ones left of p (three in bf16, 24 bits of p; two in f16, 22
//     bits), where one part would round p to 8 or 11 bits. The extra
//     products hide behind the stream as the first does;
//   * the sweep of one (batch, kv head) is split over the CL blocks of a
//     thread block cluster (CL from the shapes and the SM count alone, never
//     from kv_len; up to 16, the non-portable cluster size, so that one
//     sequence still fills the card): block j takes tiles j, j + CL,
//     j + 2 CL, ... below kv_len, so the blocks' shares differ by one tile at
//     most;
//   * the partial (acc, m, l) of the blocks meet through distributed shared
//     memory: each block merges its warps in shared memory, the cluster
//     synchronizes, and each block combines a share of the outputs from all
//     CL partials. One launch, no scratch in device memory;
//   * D = 160 (stablelm-12b): a row is three 64-element column blocks, the
//     last 32 columns past the tensor map's extent of D (zeros, and never
//     read: s = q.k^T takes 10 k16 steps and p.v 10 column pairs of 16);
//   * D = 112 (zamba2-7b's shared attention block): a row is two column
//     blocks, the last 16 columns past the map's extent of D (zeros, never
//     read: 7 k16 steps and 7 column pairs of 16). zamba2 and the other
//     multi-head configs (deepseek-moe-16b, olmoe-1b-7b, whisper-base) have
//     G = 1, so a block holds one live query head in the 16 rows of its
//     tiles: 2 FLOPs a cache element, 1/16 of the tensor cores' work used.
//     The sweep is bound by bytes all the same (at zamba2's decode shape,
//     caches (8,2080,32,112) at kv_len 2049, the least time is the 235 MB of
//     K and V over the memory rate, 0.07 ms), and the idle rows cost nothing
//     the stream would not hide;
//   * slots at or past kv_len are never used: tiles past it are not loaded,
//     the tail of the last one is masked (p = 0). Smax need not divide
//     anything.

#include <cooperative_groups.h>

#include "hopper.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr float NEG_INF = -1e30f;
constexpr int NWARPS = 4;
constexpr int NTHREADS = NWARPS * 32;
constexpr int STAGES = 3;
constexpr int MAX_CLUSTER = 16;  // blocks of a cluster: the non-portable most on Hopper
constexpr int HEADS = 8;        // query heads of one kv head a block takes: rows 0-7 of the m16 tiles
constexpr int R = 16 * NWARPS;  // cache rows a tile: 16 a warp

struct DecodeParams {
  const void* q;      // (B, H, D), rows q_sb, q_sh elements apart, D contiguous
  const int* kv_len;  // 1 element, device
  void* out;          // (B, H, D), rows o_sb, o_sh elements apart, D contiguous
  long long q_sb, q_sh, o_sb, o_sh;
  int H, G, Smax, n_gt;
  float scale;
};

// The 16-byte chunk ``ch`` (elements 8 ch .. 8 ch + 7 of D) of row ``row`` of a
// tile of R rows in the 128-byte swizzle: column blocks of 64 elements R rows
// apart, chunk c of row r at chunk c ^ (r % 8) of its 128-byte line.
__device__ __forceinline__ uint32_t chunk_addr(uint32_t tile, int row, int ch) {
  return tile + (ch >> 3) * R * ATOM + row * ATOM + (((ch & 7) ^ (row & 7)) << 4);
}

template <typename T>
struct Cvt;

template <>
struct Cvt<__nv_bfloat16> {
  static __device__ __forceinline__ __nv_bfloat16 from_float(float x) { return __float2bfloat16(x); }
};

template <>
struct Cvt<__half> {
  static __device__ __forceinline__ __half from_float(float x) { return __float2half(x); }
};

// Shared memory: STAGES x (K tile, V tile) of R rows, each row col_blocks<D>
// swizzled 128-byte blocks (the warps' partials take their place once the
// sweep is done), then the block's partial (acc of HEADS x D, m and l of
// HEADS) that the cluster reads, then the barriers.
template <int D>
struct DecodeSmem {
  static constexpr int TILE = R * col_blocks<D>() * ATOM;
  static constexpr int RING = STAGES * 2 * TILE;
  static constexpr int RES = RING;
  static constexpr int BAR = RES + (HEADS * D + 2 * HEADS) * 4;
  static constexpr int BYTES = BAR + STAGES * 8;
  static constexpr int ALLOC = BYTES + 1024;  // room to align the base for the swizzle
  static_assert(ALLOC <= 232448, "more shared memory than a block may use");
};

// One block: the tiles of rank j of the cluster, of one (batch, kv head, tile
// of 8 query heads). Each warp runs the online softmax of its 16 rows of each
// tile; the warps are merged in shared memory, the cluster's blocks through
// distributed shared memory.
template <typename T, int D>
__global__ void __launch_bounds__(NTHREADS, D == 64 ? 4 : 2)
decode_kernel(const __grid_constant__ CUtensorMap tm_k, const __grid_constant__ CUtensorMap tm_v,
              const DecodeParams p) {
  using L = DecodeSmem<D>;
  constexpr int NCB = col_blocks<D>();  // 64-element column blocks of a row

  extern __shared__ unsigned char smem_raw[];
  unsigned char* const smem = align1024(smem_raw);
  float* const res_acc = reinterpret_cast<float*>(smem + L::RES);  // [HEADS][D]
  float* const res_m = res_acc + HEADS * D;                         // [HEADS]
  float* const res_l = res_m + HEADS;                               // [HEADS]
  uint64_t* const full = reinterpret_cast<uint64_t*>(smem + L::BAR);
  const uint32_t sbase = smem_u32(smem);

  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int CL = static_cast<int>(cluster.num_blocks());
  const int kvh = blockIdx.y / p.n_gt;
  const int g0 = (blockIdx.y % p.n_gt) * HEADS;  // first query head of this block, within the group
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;  // fragment row: query head g0 + g
  const int t = lane & 3;   // fragment column pair
  const int r0 = 16 * warp; // this warp's rows of a tile

  const int kv_len = max(0, min(p.kv_len[0], p.Smax));
  const int n_all = (kv_len + R - 1) / R;                           // tiles below kv_len
  const int n_t = rank < n_all ? (n_all - rank + CL - 1) / CL : 0;  // this block's: rank + CL i

  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) mbar_init(&full[s], 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  auto issue = [&](int i) {  // tile rank + CL i into stage i % STAGES
    const int s = i % STAGES;
    const int row0 = (rank + CL * i) * R;
    const uint32_t kt = sbase + s * 2 * L::TILE;
    mbar_arrive_expect_tx(&full[s], 2 * L::TILE);
#pragma unroll
    for (int cb = 0; cb < NCB; ++cb) {
      tma_load_4d(kt + cb * R * ATOM, &tm_k, &full[s], cb * 64, kvh, row0, b);
      tma_load_4d(kt + L::TILE + cb * R * ATOM, &tm_v, &full[s], cb * 64, kvh, row0, b);
    }
  };
  if (tid == 0) {
    prefetch_map(&tm_k);
    prefetch_map(&tm_v);
    for (int i = 0; i < min(STAGES, n_t); ++i) issue(i);
  }

  // q as the A operand of s = q.k^T: row g is query head g0 + g (0 past the
  // group); rows g + 8 are padding, 0 (a[1], a[3] of every fragment)
  uint32_t qa[D / 16][2];
  {
    const bool live = g0 + g < p.G;
    const T* qrow = static_cast<const T*>(p.q) + b * p.q_sb + (kvh * p.G + g0 + g) * p.q_sh;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      qa[kk][0] = live ? *reinterpret_cast<const uint32_t*>(qrow + 16 * kk + 2 * t) : 0u;
      qa[kk][1] = live ? *reinterpret_cast<const uint32_t*>(qrow + 16 * kk + 8 + 2 * t) : 0u;
    }
  }
  const float c2 = p.scale * LOG2E;  // exp(scale * x) = exp2(c2 * x)
  float o[D / 8][4];                 // o of head g at columns 8 n + 2 t, + 1 in [0], [1]; [2], [3] padding
#pragma unroll
  for (int n = 0; n < D / 8; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  float m = NEG_INF;  // running max of head g's raw scores over this warp's rows
  float l = 0.f;      // this thread's part of the running sum

  for (int i = 0; i < n_t; ++i) {
    const int s = i % STAGES;
    const int row0 = (rank + CL * i) * R;
    mbar_wait(&full[s], (i / STAGES) & 1);
    const uint32_t kt = sbase + s * 2 * L::TILE;
    const uint32_t vt = kt + L::TILE;

    // s = q.k^T over the warp's 16 rows: two n-tiles of 8 rows
    float sc[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      uint32_t kb[4];
      ldmatrix_x4(kb, chunk_addr(kt, r0 + (lane & 7) + (lane >> 4) * 8, 2 * kk + ((lane >> 3) & 1)));
      const uint32_t a[4] = {qa[kk][0], 0u, qa[kk][1], 0u};
      mma16816<T>(sc[0], a, kb[0], kb[1]);
      mma16816<T>(sc[1], a, kb[2], kb[3]);
    }
    // head g's scores of rows r0 + 8 j + 2 t + e: x[2 j + e]
    float x[4] = {sc[0][0], sc[0][1], sc[1][0], sc[1][1]};
    const bool tail = row0 + r0 + 16 > kv_len;  // the same for the whole warp
    if (tail) {
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (row0 + r0 + 8 * (e >> 1) + 2 * t + (e & 1) >= kv_len) x[e] = NEG_INF;
    }
    const float mn = fmaxf(m, quad_max(fmaxf(fmaxf(x[0], x[1]), fmaxf(x[2], x[3]))));
    const float corr = exp2_ftz((m - mn) * c2);
    m = mn;
    float pe[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) pe[e] = exp2_ftz(fmaf(x[e], c2, -mn * c2));
    if (tail) {  // p = 0 on slots at or past kv_len, also while the max is the mask value
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (row0 + r0 + 8 * (e >> 1) + 2 * t + (e & 1) >= kv_len) pe[e] = 0.f;
    }
    l = l * corr + (pe[0] + pe[1]) + (pe[2] + pe[3]);
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      o[n][0] *= corr;
      o[n][1] *= corr;
    }
    // o += p.v: p (heads x the warp's 16 rows) as the A fragments of its
    // parts, the smallest first; V read transposed
    constexpr int NP = Split<T>::PARTS;
    uint32_t p01[NP], p23[NP];
    split_pack<T>(pe[0], pe[1], p01);
    split_pack<T>(pe[2], pe[3], p23);
#pragma unroll
    for (int n2 = 0; n2 < D / 16; ++n2) {
      uint32_t vb[4];
      ldmatrix_x4_trans(vb, chunk_addr(vt, r0 + (lane & 7) + ((lane >> 3) & 1) * 8, 2 * n2 + (lane >> 4)));
#pragma unroll
      for (int i = NP - 1; i >= 0; --i) {
        const uint32_t pa[4] = {p01[i], 0u, p23[i], 0u};
        mma16816<T>(o[2 * n2], pa, vb[0], vb[1]);
        mma16816<T>(o[2 * n2 + 1], pa, vb[2], vb[3]);
      }
    }
    __syncthreads();  // every thread is done with stage s
    if (tid == 0 && i + STAGES < n_t) issue(i + STAGES);
  }

  // ---- merge the warps of this block in shared memory, where the ring was
  l = quad_sum(l);
  float* const s_acc = reinterpret_cast<float*>(smem);  // [NWARPS][HEADS][D]
  float* const s_m = s_acc + NWARPS * HEADS * D;        // [NWARPS][HEADS]
  float* const s_l = s_m + NWARPS * HEADS;              // [NWARPS][HEADS]
  static_assert((NWARPS * HEADS * D + 2 * NWARPS * HEADS) * 4 <= L::RING, "the warps' partials must fit in the ring");
  if (t == 0) {
    s_m[warp * HEADS + g] = m;
    s_l[warp * HEADS + g] = l;
  }
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
    *reinterpret_cast<float2*>(s_acc + (warp * HEADS + g) * D + 8 * n + 2 * t) = make_float2(o[n][0], o[n][1]);
  __syncthreads();
  for (int idx = tid; idx < HEADS * D; idx += NTHREADS) {
    const int h = idx / D;
    float mt = NEG_INF;
#pragma unroll
    for (int j = 0; j < NWARPS; ++j) mt = fmaxf(mt, s_m[j * HEADS + h]);
    float lt = 0.f;
    float at = 0.f;
#pragma unroll
    for (int j = 0; j < NWARPS; ++j) {
      const float w = exp2_ftz((s_m[j * HEADS + h] - mt) * c2);
      lt += w * s_l[j * HEADS + h];
      at += w * s_acc[j * HEADS * D + idx];
    }
    res_acc[idx] = at;
    if (idx % D == 0) {
      res_m[h] = mt;
      res_l[h] = lt;
    }
  }

  // ---- combine the cluster's partials: each block a share of the outputs;
  // the reads of the other blocks' shared memory are issued together
  cluster.sync();
  for (int idx = rank * NTHREADS + tid; idx < HEADS * D; idx += CL * NTHREADS) {
    const int h = idx / D;
    const int d = idx % D;
    if (g0 + h >= p.G) continue;
    float mj[MAX_CLUSTER];
    float mt = NEG_INF;
#pragma unroll
    for (int j = 0; j < MAX_CLUSTER; ++j) {
      mj[j] = j < CL ? cluster.map_shared_rank(res_m, j)[h] : NEG_INF;
      mt = fmaxf(mt, mj[j]);
    }
    float lt = 0.f;
    float at = 0.f;
#pragma unroll
    for (int j = 0; j < MAX_CLUSTER; ++j) {
      if (j < CL) {
        const float w = exp2_ftz((mj[j] - mt) * c2);
        lt += w * cluster.map_shared_rank(res_l, j)[h];
        at += w * cluster.map_shared_rank(res_acc, j)[idx];
      }
    }
    static_cast<T*>(p.out)[b * p.o_sb + (kvh * p.G + g0 + h) * p.o_sh + d] = Cvt<T>::from_float(at / fmaxf(lt, 1e-30f));
  }
  cluster.sync();  // no block leaves while another still reads its partial
}

// The kernel's dynamic shared memory, and clusters past the portable 8 blocks
template <typename T, int D>
cudaError_t set_attributes() {
  cudaError_t err = cudaFuncSetAttribute(decode_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         DecodeSmem<D>::ALLOC);
  if (err != cudaSuccess) return err;
  return cudaFuncSetAttribute(decode_kernel<T, D>, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
}

template <typename T, int D>
int launch(const CUtensorMap (&m)[2], const DecodeParams& p, int B, int KVH, int n_split, cudaStream_t stream) {
  const int smem = DecodeSmem<D>::ALLOC;
  cudaError_t err = set_attributes<T, D>();
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(n_split, KVH * p.n_gt, B);
  cfg.blockDim = dim3(NTHREADS, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = n_split;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, decode_kernel<T, D>, m[0], m[1], p);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// Blocks that one SM holds at once, and clusters of n_split blocks that the
// card holds at once, as the CUDA runtime reckons them; -1 on an error.
template <typename T, int D>
int occupancy(int n_split, int* clusters) {
  const int smem = DecodeSmem<D>::ALLOC;
  int n = 0;
  if (set_attributes<T, D>() != cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, decode_kernel<T, D>, NTHREADS, smem) != cudaSuccess)
    return -1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(n_split, 1, 1);
  cfg.blockDim = dim3(NTHREADS, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = n_split;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  if (cudaOccupancyMaxActiveClusters(clusters, decode_kernel<T, D>, &cfg) != cudaSuccess) return -1;
  return n;
}

// (B, Smax, KVH, D) through strides s = (b, s, kvh) as a 4-D map (D, KVH,
// Smax, B) with a box of (64, 1, R, 1): R rows of one (batch, kv head), one
// 64-element column block of them, in the 128-byte swizzle. The innermost
// extent is D: at D = 112 the second block's last 16 columns and at D = 160
// the third block's last 32 read as zeros,
// never as the next kv head's
int map_cache(CUtensorMap* map, const void* base, int dtype, const long long* s, int B, int Smax, int KVH, int D) {
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(D), static_cast<cuuint64_t>(KVH),
                              static_cast<cuuint64_t>(Smax), static_cast<cuuint64_t>(B)};
  const long long st[3] = {s[2], s[1], s[0]};
  const cuuint32_t box[4] = {64, 1, static_cast<cuuint32_t>(R), 1};
  return make_map(map, base, dtype, 4, dims, st, box);
}

}  // namespace

// Strides are in elements: k b,s,kvh | v b,s,kvh | q b,h | out b,h. dtype: 0 = bf16,
// 1 = f16. A block takes 8 query heads of one kv head (a group of more takes
// several blocks). n_split = blocks of the cluster that share one sweep (1 to
// 16). Launches one kernel and returns cudaGetLastError(), or one of the
// negative ERR_ codes of hopper.cuh without launching.
extern "C" int decode_attention_launch(
    const void* q, const void* k, const void* v, const int* kv_len, void* out, const long long* strides,
    int B, int H, int KVH, int D, int Smax, int n_split, float scale, int dtype, void* stream) {
  DecodeParams p;
  p.q = q; p.kv_len = kv_len; p.out = out;
  p.q_sb = strides[6]; p.q_sh = strides[7]; p.o_sb = strides[8]; p.o_sh = strides[9];
  p.H = H; p.G = H / KVH; p.Smax = Smax; p.n_gt = (p.G + HEADS - 1) / HEADS;
  p.scale = scale;
  if (!((D == 64 || D == 112 || D == 128 || D == 160) && (dtype == 0 || dtype == 1))) return ERR_NO_KERNEL;
  if (n_split < 1 || n_split > MAX_CLUSTER) return ERR_PLAN;
  CUtensorMap m[2];
  int r;
  if ((r = map_cache(&m[0], k, dtype, strides, B, Smax, KVH, D)) != 0) return r;
  if ((r = map_cache(&m[1], v, dtype, strides + 3, B, Smax, KVH, D)) != 0) return r;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && D == 64) return launch<__nv_bfloat16, 64>(m, p, B, KVH, n_split, st);
  if (dtype == 0 && D == 128) return launch<__nv_bfloat16, 128>(m, p, B, KVH, n_split, st);
  if (dtype == 1 && D == 64) return launch<__half, 64>(m, p, B, KVH, n_split, st);
  if (dtype == 1 && D == 128) return launch<__half, 128>(m, p, B, KVH, n_split, st);
  if (dtype == 0 && D == 112) return launch<__nv_bfloat16, 112>(m, p, B, KVH, n_split, st);
  if (dtype == 1 && D == 112) return launch<__half, 112>(m, p, B, KVH, n_split, st);
  if (dtype == 0) return launch<__nv_bfloat16, 160>(m, p, B, KVH, n_split, st);
  return launch<__half, 160>(m, p, B, KVH, n_split, st);
}

// Blocks of the kernel for (D, dtype) that one SM holds at once, and in
// ``clusters`` how many clusters of n_split blocks the card holds at once.
// Returns -1 on an error, ERR_NO_KERNEL for what has no instantiation.
extern "C" int decode_attention_occupancy(int D, int dtype, int n_split, int* clusters) {
  *clusters = 0;
  if (dtype == 0 && D == 64) return occupancy<__nv_bfloat16, 64>(n_split, clusters);
  if (dtype == 0 && D == 128) return occupancy<__nv_bfloat16, 128>(n_split, clusters);
  if (dtype == 1 && D == 64) return occupancy<__half, 64>(n_split, clusters);
  if (dtype == 1 && D == 128) return occupancy<__half, 128>(n_split, clusters);
  if (dtype == 0 && D == 112) return occupancy<__nv_bfloat16, 112>(n_split, clusters);
  if (dtype == 1 && D == 112) return occupancy<__half, 112>(n_split, clusters);
  if (dtype == 0 && D == 160) return occupancy<__nv_bfloat16, 160>(n_split, clusters);
  if (dtype == 1 && D == 160) return occupancy<__half, 160>(n_split, clusters);
  return ERR_NO_KERNEL;
}
