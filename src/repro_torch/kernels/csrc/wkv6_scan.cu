// Chunked WKV6 scan (RWKV-6 "Finch" linear attention) for Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/rwkv6_scan.py::_wkv6_kernel (entry
// wkv6_scan). Same function: per (batch, head), state S (K x V, f32),
//   o_t = r_t . (S_{t-1} + (u * k_t) v_t^T)
//   S_t = diag(exp(logw_t)) S_{t-1} + k_t v_t^T
// over r, k, logw (B,T,H,K), v (B,T,H,V), u (H,K), state0 (B,H,K,V); out
// (B,T,H,V) f32 and the final state f32. K = V = 64, chunks of C = 64 tokens.
// r, k, v are bf16 or f32, read where they lie through their strides (last
// dim contiguous, rows on 16 bytes, else the wrapper copies them); logw, u
// and state0 are f32.
//
// What bounds it on this card: bytes. r, k, v in bf16 and logw and out in
// f32 are 14 bytes a (token, head, column); the work on them is 4 K^2
// products a token and head, which the tensor cores take in a sixteenth of
// the time the bytes need, and K^2 + 6 K elementwise operations, a quarter.
// Inside a chunk the recurrence is a pairwise term
//   scores[t,s] = sum_k r[t,k] k[s,k] 2^(cx[t,k] - clw[s,k])   (s < t)
// in log2 units (clw the inclusive cumulative log-decay, cx the exclusive),
// every exponent <= 0. Taken as it stands it is one exp per (t, s, k), 129 K
// a chunk and head on the CUDA cores; the whole-chunk factored form
// (r 2^{+cum}) (k 2^{-cum})^T would be a matrix product but overflows once a
// chunk's decay passes 2^-126.
//
// What the design does about it:
//  * Sub-chunks. A chunk is four sub-chunks of 16 rows, one a warp. Only the
//    four diagonal 16 x 16 blocks of the scores take one exp per (t, s, k)
//    (30,720 a chunk), on the CUDA cores. Each off-diagonal block (i, j),
//    j < i, is one product (r_i 2^(cx_i - b_j)) . (k_j 2^(b_j - clw_j))^T,
//    b_j = clw at the last row of sub-chunk j: both exponents are <= 0, so
//    nothing can overflow, whatever the decay.
//  * The tensor cores. The off-diagonal scores, scores.v, (r 2^cx).S and
//    (k 2^(clw_C - clw))^T.v are mma.sync m16n8k16 (bf16 in, f32 sums), not
//    wgmma: their operands are computed in registers (products of decays and
//    inputs), the off-diagonal blocks are 16 rows, not wgmma's 64, and the C
//    fragments of one product are the A fragments of the next. Every f32
//    operand goes in as three bf16 parts (hopper.cuh split_pack) with the
//    partial products of order <= 2: six products where both operands are
//    split, three where v is exact in bf16. Two parts would miss the float64
//    limit at the model's slow decay (tests/test_torch_wkv6_subchunk.py).
//  * Loads that overlap compute. Chunk c + 1's r, k, v and logw come into the
//    other buffer of a two-stage ring by cp.async while chunk c computes
//    (16-byte copies, rows past T zero-filled; the wrapper copies any input
//    whose rows are not 16-byte aligned).
//  * Only the S-dependent work is serial: the cumulative sum, the scores and
//    (k 2^(clw_C - clw))^T.v of a chunk do not read S. Warp i keeps rows
//    16 i .. 16 i + 15 of S in registers (f32) and writes its three bf16
//    parts to shared memory for the next chunk's (r 2^cx).S.
//  * Occupancy. Shared memory rows are kept whole and conflict-free by an
//    XOR swizzle of their 16-byte chunks. At bf16 and V = 64 a block of 4
//    warps takes 108.5 KB and 249 registers a thread, no spill, so an SM
//    holds two: at rwkv6's prefill shape, 256 (batch, head) blocks on 132 SMs
//    run in one wave. The loops of the diagonal pass, (r 2^cx).S and the
//    state's product are not unrolled, which keeps every instantiation
//    within 255 registers. When B*H blocks would leave SMs idle the wrapper
//    splits V into 2 or 4 slices (each recomputes the scores).
//  * What paces it: instruction issue. The chunk's operands are built
//    element by element (an exp, a product and a three-part split each), and
//    their swizzled addresses take more of the instructions than the
//    arithmetic does; the diagonal blocks, the off-diagonal blocks and the
//    three other products each take about a quarter of the time, the stream
//    of loads hides under them (PERF.md).
//  * Rows past T (a short last chunk) are read as r = k = v = 0, logw = 0:
//    they leave the state alone, and their outputs are not written.

#include "hopper.cuh"

namespace {

constexpr int C = 64;          // chunk length
constexpr int K = 64;          // key (and value) head size
constexpr int SUB = 16;        // sub-chunk: the rows of one warp
constexpr int NWARP = C / SUB;
constexpr int NT = 32 * NWARP;
constexpr int NP = Split<__nv_bfloat16>::PARTS;  // bf16 parts of an f32 operand
// each warp's diagonal block of the scores, 16 x 16 f32 in shared memory
constexpr int BLOCK_BYTES = SUB * SUB * 4;
constexpr int CH_BLOCK = SUB * 4 / 16;

using bf16 = __nv_bfloat16;

struct WkvParams {
  const void* r;
  const void* k;
  const void* v;
  const float* w;    // logw
  const float* u;    // (H, K) contiguous
  const float* s0;   // (B, H, K, V) contiguous
  float* out;        // (B, T, H, V) contiguous
  float* s_out;      // (B, H, K, V) contiguous
  long long r_sb, r_st, r_sh;
  long long k_sb, k_st, k_sh;
  long long v_sb, v_st, v_sh;
  long long w_sb, w_st, w_sh;
  int B, T, H;
};

// 16-byte chunk c of row ``row`` of an array whose rows are CH chunks: XOR
// swizzled so that 8 rows read at one column meet 8 different bank groups
template <int CH>
__device__ __forceinline__ int swz(int row, int c) {
  if constexpr (CH >= 8) return c ^ (row & 7);
  else return c ^ ((row / (8 / CH)) & (CH - 1));
}

// byte offset of byte ``b`` of row ``row``
template <int CH>
__device__ __forceinline__ uint32_t soff(int row, int b) {
  return row * (CH * 16) + (swz<CH>(row, b >> 4) << 4) + (b & 15);
}

// Shared memory of one block: two stages of (r, k, v, logw), then the NP
// bf16 parts of S (K x VS), the score blocks, each warp's bonus, u.
template <typename T, int VS>
struct Smem {
  static constexpr int E = sizeof(T);
  static constexpr int CH_RK = K * E / 16;  // chunks a row of r, k
  static constexpr int CH_V = VS * E / 16;  // of v
  static constexpr int CH_W = K * 4 / 16;   // of logw, then clw
  static constexpr int CH_S = VS * 2 / 16;  // of a part of S
  static constexpr int R = 0;
  static constexpr int KK = R + C * K * E;
  static constexpr int V = KK + C * K * E;
  static constexpr int W = V + C * VS * E;
  static constexpr int STAGE = W + C * K * 4;
  static constexpr int S = 2 * STAGE;
  static constexpr int DG = S + NP * K * VS * 2;
  static constexpr int DS = DG + NWARP * BLOCK_BYTES;
  static constexpr int U = DS + NWARP * SUB * 4;
  static constexpr int BYTES = U + K * 4;
};

// ---- loads

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" :: "r"(dst), "l"(src), "r"(bytes) : "memory");
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }
__device__ __forceinline__ void cp_async_wait_all() { asm volatile("cp.async.wait_group 0;\n" ::: "memory"); }

// C rows of CH 16-byte chunks from ``src`` (rows ``stride`` bytes apart, each
// starting on 16 bytes) into the array at ``dst`` by cp.async; rows at or past
// ``nv`` are zero.
template <int CH>
__device__ __forceinline__ void load_rows(unsigned char* dst, const unsigned char* src, long long stride, int nv,
                                          int tid) {
  const uint32_t d = smem_u32(dst);
  for (int i = tid; i < C * CH; i += NT) {
    const int row = i / CH, c = i % CH;
    const bool ok = row < nv;
    cp_async16(d + soff<CH>(row, c * 16), ok ? src + row * stride + c * 16 : src, ok ? 16 : 0);
  }
}

// ---- reads of shared memory as f32

template <typename T>
struct Ld;

template <>
struct Ld<bf16> {
  static __device__ __forceinline__ float one(const unsigned char* p) {
    return __uint_as_float(static_cast<uint32_t>(*reinterpret_cast<const uint16_t*>(p)) << 16);
  }
  static __device__ __forceinline__ float2 two(const unsigned char* p) {
    return Split<bf16>::unpack(*reinterpret_cast<const uint32_t*>(p));
  }
  // elements 8 c .. 8 c + 7 of a row (one 16-byte chunk)
  template <int CH>
  static __device__ __forceinline__ void eight(const unsigned char* a, int row, int c, float (&x)[8]) {
    const uint4 u = *reinterpret_cast<const uint4*>(a + soff<CH>(row, 16 * c));
    const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = Split<bf16>::unpack(w[i]);
      x[2 * i] = f.x;
      x[2 * i + 1] = f.y;
    }
  }
};

template <>
struct Ld<float> {
  static __device__ __forceinline__ float one(const unsigned char* p) { return *reinterpret_cast<const float*>(p); }
  static __device__ __forceinline__ float2 two(const unsigned char* p) {
    return *reinterpret_cast<const float2*>(p);
  }
  template <int CH>
  static __device__ __forceinline__ void eight(const unsigned char* a, int row, int c, float (&x)[8]) {
    const float4 lo = *reinterpret_cast<const float4*>(a + soff<CH>(row, 32 * c));
    const float4 hi = *reinterpret_cast<const float4*>(a + soff<CH>(row, 32 * c + 16));
    x[0] = lo.x; x[1] = lo.y; x[2] = lo.z; x[3] = lo.w;
    x[4] = hi.x; x[5] = hi.y; x[6] = hi.z; x[7] = hi.w;
  }
};

// ---- tensor-core products on split operands

// The NP A fragments of a 16 x 16 f32 tile given by its four pairs of a
// lane: (row g, cols 2q, 2q+1), (g + 8, 2q..), (g, 2q + 8..), (g + 8, 2q + 8..)
__device__ __forceinline__ void a_parts(uint32_t (&a)[NP][4], const float2 (&x)[4]) {
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    uint32_t pp[NP];
    split_pack<bf16>(x[j].x, x[j].y, pp);
#pragma unroll
    for (int i = 0; i < NP; ++i) a[i][j] = pp[i];
  }
}

// The NB B fragments of a 16 x 8 tile from its two pairs of a lane:
// (rows 2q, 2q + 1; col g) and (rows 2q + 8, 2q + 9; col g); NB = 1: exact
template <int NB>
__device__ __forceinline__ void b_parts(uint32_t (&b)[NB][2], float2 x0, float2 x1) {
  uint32_t p0[NP], p1[NP];
  split_pack<bf16>(x0.x, x0.y, p0);
  split_pack<bf16>(x1.x, x1.y, p1);
#pragma unroll
  for (int i = 0; i < NB; ++i) {
    b[i][0] = p0[i];
    b[i][1] = p1[i];
  }
}

// d += a . b over the parts of order <= 2 (NB = 1: b exact)
template <int NB>
__device__ __forceinline__ void mma_parts(float (&d)[4], const uint32_t (&a)[NP][4], const uint32_t (&b)[NB][2]) {
#pragma unroll
  for (int i = 0; i < NP; ++i)
#pragma unroll
    for (int j = 0; j < NB; ++j)
      if (i + j < NP) mma16816<bf16>(d, a[i], b[j][0], b[j][1]);
}

// B fragments of v for two n8 tiles (columns n0 .. n0 + 15), rows s0 .. s0 + 15
// of the stage: bf16 by ldmatrix (exact, one part), f32 split in NP parts
template <typename T, int VS>
struct VFrag {
  static constexpr int NB = sizeof(T) == 2 ? 1 : NP;
  static __device__ __forceinline__ void load(const unsigned char* vs, int s0, int n0, int lane,
                                              uint32_t (&b)[2][NB][2]) {
    using L = Smem<T, VS>;
    if constexpr (sizeof(T) == 2) {
      uint32_t x[4];
      const int row = s0 + (lane & 7) + ((lane >> 3) & 1) * 8;
      ldmatrix_x4_trans(x, smem_u32(vs) + soff<L::CH_V>(row, 2 * n0 + 16 * (lane >> 4)));
      b[0][0][0] = x[0]; b[0][0][1] = x[1];
      b[1][0][0] = x[2]; b[1][0][1] = x[3];
    } else {
      const int g = lane >> 2, q = lane & 3;
#pragma unroll
      for (int n = 0; n < 2; ++n) {
        const int col = 4 * (n0 + 8 * n + g);
        const auto at = [&](int row) { return Ld<float>::one(vs + soff<L::CH_V>(row, col)); };
        b_parts<NB>(b[n], make_float2(at(s0 + 2 * q), at(s0 + 2 * q + 1)),
                    make_float2(at(s0 + 2 * q + 8), at(s0 + 2 * q + 9)));
      }
    }
  }
};

// One block: one (batch, head, slice of VS value columns), all chunks; warp i
// the rows 16 i .. 16 i + 15 of each chunk's out and of S.
template <typename T, int VS>
__global__ void __launch_bounds__(NT, sizeof(T) == 2 ? 2 : 1) wkv6_kernel(const WkvParams p) {
  using L = Smem<T, VS>;
  using V = VFrag<T, VS>;
  constexpr int E = sizeof(T);
  constexpr int NTN = VS / 8;  // n8 tiles of the value columns
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned char* const sS = smem + L::S;
  unsigned char* const blocks = smem + L::DG;
  float* const ds_all = reinterpret_cast<float*>(smem + L::DS);
  float* const uS = reinterpret_cast<float*>(smem + L::U);

  const int v0 = blockIdx.x * VS;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int q = lane & 3;
  const int n_chunks = (p.T + C - 1) / C;
  const long long bh = static_cast<long long>(b) * p.H + h;

  const unsigned char* const rb = static_cast<const unsigned char*>(p.r) + (b * p.r_sb + h * p.r_sh) * E;
  const unsigned char* const kb = static_cast<const unsigned char*>(p.k) + (b * p.k_sb + h * p.k_sh) * E;
  const unsigned char* const vb = static_cast<const unsigned char*>(p.v) + (b * p.v_sb + h * p.v_sh + v0) * E;
  const unsigned char* const wb = reinterpret_cast<const unsigned char*>(p.w) + (b * p.w_sb + h * p.w_sh) * 4;

  const auto load_chunk = [&](int ch) {
    unsigned char* st = smem + (ch & 1) * L::STAGE;
    const long long t0 = static_cast<long long>(ch) * C;
    const int nv = min(C, p.T - ch * C);
    load_rows<L::CH_RK>(st + L::R, rb + t0 * p.r_st * E, p.r_st * E, nv, tid);
    load_rows<L::CH_RK>(st + L::KK, kb + t0 * p.k_st * E, p.k_st * E, nv, tid);
    load_rows<L::CH_V>(st + L::V, vb + t0 * p.v_st * E, p.v_st * E, nv, tid);
    load_rows<L::CH_W>(st + L::W, wb + t0 * p.w_st * 4, p.w_st * 4, nv, tid);
  };

  // rows of S this lane holds: r0 = 16 warp + g and r0 + 8; columns 8 n + 2q, + 1
  const int r0 = SUB * warp + g;
  float sreg[NTN][4];
  const auto store_s_parts = [&]() {
#pragma unroll
    for (int n = 0; n < NTN; ++n)
#pragma unroll
      for (int hlf = 0; hlf < 2; ++hlf) {
        uint32_t pp[NP];
        split_pack<bf16>(sreg[n][2 * hlf], sreg[n][2 * hlf + 1], pp);
#pragma unroll
        for (int i = 0; i < NP; ++i)
          *reinterpret_cast<uint32_t*>(sS + i * K * VS * 2 + soff<L::CH_S>(r0 + 8 * hlf, 2 * (8 * n + 2 * q))) = pp[i];
      }
  };

  load_chunk(0);
  cp_async_commit();
  for (int i = tid; i < NWARP * SUB * SUB; i += NT) reinterpret_cast<float*>(blocks)[i] = 0.f;
  if (tid < K) uS[tid] = p.u[h * K + tid];
  {
    const float* s0 = p.s0 + bh * K * K + v0;
#pragma unroll
    for (int n = 0; n < NTN; ++n)
#pragma unroll
      for (int hlf = 0; hlf < 2; ++hlf) {
        const float2 x = *reinterpret_cast<const float2*>(s0 + (r0 + 8 * hlf) * K + 8 * n + 2 * q);
        sreg[n][2 * hlf] = x.x;
        sreg[n][2 * hlf + 1] = x.y;
      }
  }
  store_s_parts();

  // a diagonal block (zero above the diagonal): element (t, s) at byte bo(t, s)
  const auto bo = [](int t, int s) { return soff<CH_BLOCK>(t, 4 * s); };
  unsigned char* const dg = blocks + warp * BLOCK_BYTES;
  float* const dsum = ds_all + warp * SUB;  // this warp's bonus r_t.(u k_t)

  for (int ch = 0; ch < n_chunks; ++ch) {
    const int nv = min(C, p.T - ch * C);
    const unsigned char* const st = smem + (ch & 1) * L::STAGE;
    const unsigned char* const sr = st + L::R;
    const unsigned char* const sk = st + L::KK;
    const unsigned char* const sv = st + L::V;
    unsigned char* const sw = smem + (ch & 1) * L::STAGE + L::W;

    cp_async_wait_all();
    __syncthreads();  // this chunk has landed; S's parts are written; the other stage is free
    if (ch + 1 < n_chunks) load_chunk(ch + 1);
    cp_async_commit();

    // ---- inclusive cumulative sum of logw * log2(e) along t, in place: two
    // lanes a column, rows 0-31 and 32-63, joined by a shuffle
    {
      const int kk = tid >> 1;
      const int half = tid & 1;
      float x[32];
      float run = 0.f;
#pragma unroll
      for (int t = 0; t < 32; ++t) {
        run += Ld<float>::one(sw + soff<L::CH_W>(32 * half + t, 4 * kk)) * LOG2E;
        x[t] = run;
      }
      const float first = __shfl_sync(0xffffffffu, run, lane & ~1);
#pragma unroll
      for (int t = 0; t < 32; ++t)
        *reinterpret_cast<float*>(sw + soff<L::CH_W>(32 * half + t, 4 * kk)) = half ? x[t] + first : x[t];
    }
    __syncthreads();

    // clw[t][k .. k + 1]; cx[t] = clw[t - 1] (0 at t = 0)
    const auto cw2 = [&](int t, int kk) { return Ld<float>::two(sw + soff<L::CH_W>(t, 4 * kk)); };
    const auto cx2 = [&](int t, int kk) { return t > 0 ? cw2(t - 1, kk) : make_float2(0.f, 0.f); };
    const int tw = SUB * warp;  // first row of this warp's sub-chunk

    // ---- the diagonal block: one exp per (t, s, k), s < t. Lane (pg, kq)
    // takes rows pg and 15 - pg (15 pairs) and their bonus r_t.(u k_t) over
    // k = 16 kq .. 16 kq + 15; the 4 lanes of a row group are summed. The loop
    // over the pairs is not unrolled, which bounds the registers it holds.
    {
      const int pg = lane >> 2;
      const int kq = lane & 3;
      const int ta = tw + pg, tb = tw + SUB - 1 - pg;
      float ra[2][8], rbv[2][8], xa[2][8], xb[2][8];
      float bon[2] = {0.f, 0.f};
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int c8 = 2 * kq + hf;  // elements 8 c8 .. 8 c8 + 7 of k
        Ld<T>::template eight<L::CH_RK>(sr, ta, c8, ra[hf]);
        Ld<T>::template eight<L::CH_RK>(sr, tb, c8, rbv[hf]);
        // a row with an entry (s < t) is past the first: ta > 0 where e < pg
        Ld<float>::template eight<L::CH_W>(sw, max(ta - 1, 0), c8, xa[hf]);
        Ld<float>::template eight<L::CH_W>(sw, tb - 1, c8, xb[hf]);
        float ka[8], kb8[8];
        Ld<T>::template eight<L::CH_RK>(sk, ta, c8, ka);
        Ld<T>::template eight<L::CH_RK>(sk, tb, c8, kb8);
#pragma unroll
        for (int m = 0; m < 8; ++m) {
          const float u = uS[8 * c8 + m];
          bon[0] = fmaf(ra[hf][m] * u, ka[m], bon[0]);
          bon[1] = fmaf(rbv[hf][m] * u, kb8[m], bon[1]);
        }
      }
#pragma unroll 1
      for (int e = 0; e < 15; ++e) {
        const bool on_a = e < pg;  // row ta, s = e; else row tb, s = e - pg
        const int s = tw + (on_a ? e : e - pg);
        float part[2] = {0.f, 0.f};
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          float kv[8], cs[8];
          Ld<T>::template eight<L::CH_RK>(sk, s, 2 * kq + hf, kv);
          Ld<float>::template eight<L::CH_W>(sw, s, 2 * kq + hf, cs);
#pragma unroll
          for (int m = 0; m < 8; ++m) {
            const float f = exp2_ftz((on_a ? xa[hf][m] : xb[hf][m]) - cs[m]);
            part[hf] = fmaf((on_a ? ra[hf][m] : rbv[hf][m]) * kv[m], f, part[hf]);
          }
        }
        float acc = part[0] + part[1];
        acc += __shfl_xor_sync(0xffffffffu, acc, 1);
        acc += __shfl_xor_sync(0xffffffffu, acc, 2);
        if ((e & 3) == kq) *reinterpret_cast<float*>(dg + bo(on_a ? pg : SUB - 1 - pg, on_a ? e : e - pg)) = acc;
      }
#pragma unroll
      for (int a = 0; a < 2; ++a) {
        bon[a] += __shfl_xor_sync(0xffffffffu, bon[a], 1);
        bon[a] += __shfl_xor_sync(0xffffffffu, bon[a], 2);
      }
      if (kq == 0) {
        dsum[pg] = bon[0];
        dsum[SUB - 1 - pg] = bon[1];
      }
    }
    __syncwarp();

    // ---- an off-diagonal block (i, j), j < i: one product, into sc
    const auto off_diagonal = [&](int i, int j, float (&sc)[2][4]) {
      const int ti = SUB * i;
      const int bj = SUB * j + SUB - 1;  // the reference point's row
#pragma unroll
      for (int n = 0; n < 2; ++n)
#pragma unroll
        for (int x = 0; x < 4; ++x) sc[n][x] = 0.f;
#pragma unroll
      for (int ks = 0; ks < K / 16; ++ks) {
        const int k0 = 16 * ks + 2 * q;
        float2 xa[4];
#pragma unroll
        for (int f = 0; f < 4; ++f) {
          const int t = ti + g + 8 * (f & 1);
          const int kk = k0 + 8 * (f >> 1);
          const float2 rr = Ld<T>::two(sr + soff<L::CH_RK>(t, E * kk));
          const float2 cx = cw2(t - 1, kk);
          const float2 bb = cw2(bj, kk);
          xa[f] = make_float2(rr.x * exp2_ftz(cx.x - bb.x), rr.y * exp2_ftz(cx.y - bb.y));
        }
        uint32_t a[NP][4];
        a_parts(a, xa);
#pragma unroll
        for (int n = 0; n < 2; ++n) {
          const int s = SUB * j + 8 * n + g;
          float2 xb[2];
#pragma unroll
          for (int f = 0; f < 2; ++f) {
            const int kk = k0 + 8 * f;
            const float2 kv = Ld<T>::two(sk + soff<L::CH_RK>(s, E * kk));
            const float2 cs = cw2(s, kk);
            const float2 bb = cw2(bj, kk);
            xb[f] = make_float2(kv.x * exp2_ftz(bb.x - cs.x), kv.y * exp2_ftz(bb.y - cs.y));
          }
          uint32_t bp[NP][2];
          b_parts<NP>(bp, xb[0], xb[1]);
          mma_parts<NP>(sc[n], a, bp);
        }
      }
    };

    float acc[NTN][4];
#pragma unroll
    for (int n = 0; n < NTN; ++n)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[n][i] = 0.f;

    // a scores block (rows of this warp, columns s0 .. s0 + 15) as A parts, times v
    const auto scores_v = [&](const float2 (&x)[4], int s0) {
      uint32_t a[NP][4];
      a_parts(a, x);
#pragma unroll
      for (int n2 = 0; n2 < NTN / 2; ++n2) {
        uint32_t bv[2][V::NB][2];
        V::load(sv, s0, 16 * n2, lane, bv);
        mma_parts<V::NB>(acc[2 * n2], a, bv[0]);
        mma_parts<V::NB>(acc[2 * n2 + 1], a, bv[1]);
      }
    };
    // ---- the off-diagonal blocks (warp, j), j < warp, then the diagonal one
#pragma unroll 1
    for (int j = 0; j < warp; ++j) {
      float sc[2][4];
      off_diagonal(warp, j, sc);
      const float2 x[4] = {make_float2(sc[0][0], sc[0][1]), make_float2(sc[0][2], sc[0][3]),
                           make_float2(sc[1][0], sc[1][1]), make_float2(sc[1][2], sc[1][3])};
      scores_v(x, SUB * j);
    }
    {
      const float2 x[4] = {*reinterpret_cast<const float2*>(dg + bo(g, 2 * q)),
                           *reinterpret_cast<const float2*>(dg + bo(g + 8, 2 * q)),
                           *reinterpret_cast<const float2*>(dg + bo(g, 2 * q + 8)),
                           *reinterpret_cast<const float2*>(dg + bo(g + 8, 2 * q + 8))};
      scores_v(x, tw);
    }

    // ---- the bonus (r_t.(u k_t)) v_t
#pragma unroll
    for (int hlf = 0; hlf < 2; ++hlf) {
      const float d = dsum[g + 8 * hlf];
#pragma unroll
      for (int n = 0; n < NTN; ++n) {
        const float2 vv = Ld<T>::two(sv + soff<L::CH_V>(tw + g + 8 * hlf, E * (8 * n + 2 * q)));
        acc[n][2 * hlf] = fmaf(d, vv.x, acc[n][2 * hlf]);
        acc[n][2 * hlf + 1] = fmaf(d, vv.y, acc[n][2 * hlf + 1]);
      }
    }

    // ---- (r 2^cx) . S
#pragma unroll 1
    for (int ks = 0; ks < K / 16; ++ks) {
      const int k0 = 16 * ks + 2 * q;
      float2 xa[4];
#pragma unroll
      for (int f = 0; f < 4; ++f) {
        const int t = tw + g + 8 * (f & 1);
        const int kk = k0 + 8 * (f >> 1);
        const float2 rr = Ld<T>::two(sr + soff<L::CH_RK>(t, E * kk));
        const float2 cx = cx2(t, kk);
        xa[f] = make_float2(rr.x * exp2_ftz(cx.x), rr.y * exp2_ftz(cx.y));
      }
      uint32_t a[NP][4];
      a_parts(a, xa);
#pragma unroll
      for (int n2 = 0; n2 < NTN / 2; ++n2) {
        uint32_t sb[NP][4];
        const int row = 16 * ks + (lane & 7) + ((lane >> 3) & 1) * 8;
#pragma unroll
        for (int i = 0; i < NP; ++i)
          ldmatrix_x4_trans(sb[i], smem_u32(sS + i * K * VS * 2) + soff<L::CH_S>(row, 2 * (16 * n2) + 16 * (lane >> 4)));
        uint32_t b0[NP][2], b1[NP][2];
#pragma unroll
        for (int i = 0; i < NP; ++i) {
          b0[i][0] = sb[i][0]; b0[i][1] = sb[i][1];
          b1[i][0] = sb[i][2]; b1[i][1] = sb[i][3];
        }
        mma_parts<NP>(acc[2 * n2], a, b0);
        mma_parts<NP>(acc[2 * n2 + 1], a, b1);
      }
    }

    // ---- out
#pragma unroll
    for (int hlf = 0; hlf < 2; ++hlf) {
      const int t = tw + g + 8 * hlf;
      if (t < nv) {
        float* o = p.out + ((static_cast<long long>(b) * p.T + static_cast<long long>(ch) * C + t) * p.H + h) * K + v0;
#pragma unroll
        for (int n = 0; n < NTN; ++n)
          *reinterpret_cast<float2*>(o + 8 * n + 2 * q) = make_float2(acc[n][2 * hlf], acc[n][2 * hlf + 1]);
      }
    }

    // ---- (k 2^(clw_C - clw))^T . v for rows r0, r0 + 8 of S, into acc
#pragma unroll
    for (int n = 0; n < NTN; ++n)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[n][i] = 0.f;
    const float cl0 = Ld<float>::one(sw + soff<L::CH_W>(C - 1, 4 * r0));
    const float cl1 = Ld<float>::one(sw + soff<L::CH_W>(C - 1, 4 * (r0 + 8)));
#pragma unroll 1
    for (int ks = 0; ks < C / 16; ++ks) {
      const int s0 = 16 * ks + 2 * q;
      float2 xa[4];
#pragma unroll
      for (int f = 0; f < 4; ++f) {
        const int kk = r0 + 8 * (f & 1);
        const float cl = (f & 1) ? cl1 : cl0;
        const int s = s0 + 8 * (f >> 1);
        const float k_0 = Ld<T>::one(sk + soff<L::CH_RK>(s, E * kk));
        const float k_1 = Ld<T>::one(sk + soff<L::CH_RK>(s + 1, E * kk));
        const float c_0 = Ld<float>::one(sw + soff<L::CH_W>(s, 4 * kk));
        const float c_1 = Ld<float>::one(sw + soff<L::CH_W>(s + 1, 4 * kk));
        xa[f] = make_float2(k_0 * exp2_ftz(cl - c_0), k_1 * exp2_ftz(cl - c_1));
      }
      uint32_t a[NP][4];
      a_parts(a, xa);
#pragma unroll
      for (int n2 = 0; n2 < NTN / 2; ++n2) {
        uint32_t bv[2][V::NB][2];
        V::load(sv, 16 * ks, 16 * n2, lane, bv);
        mma_parts<V::NB>(acc[2 * n2], a, bv[0]);
        mma_parts<V::NB>(acc[2 * n2 + 1], a, bv[1]);
      }
    }

    __syncthreads();  // every warp has read S's parts
    const float d0 = exp2_ftz(cl0), d1 = exp2_ftz(cl1);
#pragma unroll
    for (int n = 0; n < NTN; ++n) {
      sreg[n][0] = fmaf(d0, sreg[n][0], acc[n][0]);
      sreg[n][1] = fmaf(d0, sreg[n][1], acc[n][1]);
      sreg[n][2] = fmaf(d1, sreg[n][2], acc[n][2]);
      sreg[n][3] = fmaf(d1, sreg[n][3], acc[n][3]);
    }
    store_s_parts();
  }

  float* so = p.s_out + bh * K * K + v0;
#pragma unroll
  for (int n = 0; n < NTN; ++n)
#pragma unroll
    for (int hlf = 0; hlf < 2; ++hlf)
      *reinterpret_cast<float2*>(so + (r0 + 8 * hlf) * K + 8 * n + 2 * q) =
          make_float2(sreg[n][2 * hlf], sreg[n][2 * hlf + 1]);
}

template <typename T, int VS>
cudaError_t set_attributes() {
  cudaError_t err = cudaFuncSetAttribute(wkv6_kernel<T, VS>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         Smem<T, VS>::BYTES);
  if (err != cudaSuccess) return err;
  return cudaFuncSetAttribute(wkv6_kernel<T, VS>, cudaFuncAttributePreferredSharedMemoryCarveout,
                              cudaSharedmemCarveoutMaxShared);
}

template <typename T, int VS>
int launch(const WkvParams& p, cudaStream_t stream) {
  const cudaError_t err = set_attributes<T, VS>();
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid(K / VS, p.H, p.B);
  wkv6_kernel<T, VS><<<grid, NT, Smem<T, VS>::BYTES, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int VS>
int blocks_per_sm() {
  if (set_attributes<T, VS>() != cudaSuccess) return -1;
  int n = 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, wkv6_kernel<T, VS>, NT, Smem<T, VS>::BYTES) != cudaSuccess)
    return -1;
  return n;
}

template <typename T>
int launch_split(const WkvParams& p, int n_split, cudaStream_t stream) {
  switch (n_split) {
    case 1: return launch<T, 64>(p, stream);
    case 2: return launch<T, 32>(p, stream);
    case 4: return launch<T, 16>(p, stream);
    default: return -1;
  }
}

}  // namespace

// Strides are in elements, (batch, time, head) of r, k, v, logw in that
// order; the last dim of each is contiguous and every row of each starts on
// 16 bytes (the loads are 16-byte cp.async). u, state0, out and state_out
// are contiguous. dtype of r, k, v: 0 = bf16, 1 = f32. n_split: blocks that
// share the V columns of one (batch, head): 1, 2 or 4. Head size is 64.
// Returns cudaGetLastError(), or -1 for a dtype or n_split with no
// instantiation.
extern "C" int wkv6_scan_launch(
    const void* r, const void* k, const void* v, const float* logw, const float* u,
    const float* state0, float* out, float* state_out, const long long* strides,
    int B, int T, int H, int n_split, int dtype, void* stream) {
  WkvParams p;
  p.r = r; p.k = k; p.v = v; p.w = logw; p.u = u; p.s0 = state0;
  p.out = out; p.s_out = state_out;
  p.r_sb = strides[0]; p.r_st = strides[1]; p.r_sh = strides[2];
  p.k_sb = strides[3]; p.k_st = strides[4]; p.k_sh = strides[5];
  p.v_sb = strides[6]; p.v_st = strides[7]; p.v_sh = strides[8];
  p.w_sb = strides[9]; p.w_st = strides[10]; p.w_sh = strides[11];
  p.B = B; p.T = T; p.H = H;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch_split<__nv_bfloat16>(p, n_split, st);
  if (dtype == 1) return launch_split<float>(p, n_split, st);
  return -1;
}

// Blocks of the kernel for ``n_split`` and ``dtype`` (as above) that one SM
// holds at once, from its registers and shared memory; -1 if none exists.
extern "C" int wkv6_scan_blocks_per_sm(int n_split, int dtype) {
  if (dtype == 0) {
    if (n_split == 1) return blocks_per_sm<__nv_bfloat16, 64>();
    if (n_split == 2) return blocks_per_sm<__nv_bfloat16, 32>();
    if (n_split == 4) return blocks_per_sm<__nv_bfloat16, 16>();
  } else if (dtype == 1) {
    if (n_split == 1) return blocks_per_sm<float, 64>();
    if (n_split == 2) return blocks_per_sm<float, 32>();
    if (n_split == 4) return blocks_per_sm<float, 16>();
  }
  return -1;
}
