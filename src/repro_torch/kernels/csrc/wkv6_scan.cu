// Chunked WKV6 scan (RWKV-6 "Finch" linear attention) for Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/rwkv6_scan.py::_wkv6_kernel (entry
// wkv6_scan). Same function: per (batch, head), state S (K x V, f32),
//   o_t = r_t . (S_{t-1} + (u * k_t) v_t^T)
//   S_t = diag(exp(logw_t)) S_{t-1} + k_t v_t^T
// over r, k, logw (B,T,H,K), v (B,T,H,V), u (H,K), state0 (B,H,K,V); out
// (B,T,H,V) f32 and the final state f32. K = V = 64, chunks of C = 64 tokens.
// r, k, v are bf16 or f32, read where they lie through their strides (last
// dim contiguous); logw, u and state0 are f32.
//
// What bounds it on this card: operations, on the CUDA cores. Inside a chunk
// the pairwise term scores[t,s] = sum_k r[t,k] k[s,k] exp(clw_ex[t,k] -
// clw[s,k]) (s < t) takes one exp per (t, s, k): 2,016 pairs x 64 per chunk
// and head, about 129 K, against 4 K bytes of input a row. It is kept in the
// reference's difference-of-cumulative-sums form, where every exponent is
// <= 0: the factored (r e^{+cum}) (k e^{-cum})^T form would turn it into a
// matrix product but overflows once a chunk's decay passes e^{-88}.
//
// What the design does about it:
//  * The TPU grid (B, H, n_chunks) carries S in VMEM along its sequential
//    chunk axis. Here one block owns a (batch, head, slice of V) and loops over
//    the chunks itself, S in shared memory: state0 is read once and the final
//    state written once. The V columns are independent in both o and S, so
//    when B*H blocks would leave SMs idle the wrapper splits V into 2 or 4
//    slices (each slice recomputes the scores).
//  * The (C, C, K) decay tensor of the TPU kernel (1 MiB) never exists: each
//    of 136 threads owns a 4x4 (t, s) tile on or below the diagonal and sums
//    over k in registers, exp by ex2.approx on log2-scaled cumulative sums.
//    Tiles wholly above the diagonal are skipped; the idle threads take the
//    diagonal bonus r_t.(u*k_t).
//  * r, k and the cumulative log-decay are stored transposed ([k][t], row
//    stride 65) so that the tile loops and the transposing stores are free of
//    bank conflicts. The cumulative sum is a 16-long serial scan per thread
//    joined across 4 lanes by shuffles.
//  * The three products (scores.v, (r e^{clw_ex}).S, (k e^{clw_C-clw})^T.v)
//    are f32 FMAs; a thread owns 4 rows x V/16 columns, its out rows paired
//    (t and 63-t) so that the causal scores.v loop is the same length for all.
//  * Rows past T (a short last chunk) are read as r = k = v = 0, logw = 0:
//    they leave the state alone, and their outputs are not written.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int C = 64;       // chunk length
constexpr int K = 64;       // key (and value) head size
constexpr int NT = 256;     // threads a block
constexpr int LD = C + 1;   // row stride of the transposed [k][t] tiles
constexpr int N_TILES = 136;  // 4x4 (t, s) tiles on or below the diagonal: 16 * 17 / 2
constexpr float LOG2E = 1.4426950408889634f;

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

template <typename T>
__device__ __forceinline__ float to_f(T x);
template <>
__device__ __forceinline__ float to_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ float to_f<__nv_bfloat16>(__nv_bfloat16 x) { return __bfloat162float(x); }

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

template <int VS>
constexpr int smem_floats() {
  return 4 * K * LD + 2 * C * VS + 3 * K;
}

// One block: one (batch, head, slice of VS value columns), all chunks.
template <typename T, int VS>
__global__ void __launch_bounds__(NT, 2) wkv6_kernel(const WkvParams p) {
  constexpr int TV = VS / 16;  // value columns a thread owns in out and S
  extern __shared__ float smem[];
  float* rT = smem;            // [K][LD]: r, then r * e^{clw_ex}
  float* kT = rT + K * LD;     // [K][LD]: k, then k * e^{clw_C - clw}
  float* cT = kT + K * LD;     // [K][LD]: 0, clw[0..C-1] (log2 units): clw_ex[t] = [t], clw[t] = [t+1]
  float* scT = cT + K * LD;    // [C][LD]: scores[t][s] at s * LD + t
  float* vS = scT + C * LD;    // [C][VS]
  float* S = vS + C * VS;      // [K][VS] carried state
  float* uS = S + K * VS;      // [K]
  float* dsum = uS + K;        // [C] diagonal bonus r_t.(u*k_t)
  float* clast = dsum + C;     // [K] clw at the chunk's last row

  const int v0 = blockIdx.x * VS;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int n_chunks = (p.T + C - 1) / C;

  const T* rb = static_cast<const T*>(p.r) + b * p.r_sb + h * p.r_sh;
  const T* kb = static_cast<const T*>(p.k) + b * p.k_sb + h * p.k_sh;
  const T* vb = static_cast<const T*>(p.v) + b * p.v_sb + h * p.v_sh + v0;
  const float* wb = p.w + b * p.w_sb + h * p.w_sh;
  const long long bh = static_cast<long long>(b) * p.H + h;

  const float* s0 = p.s0 + bh * K * K + v0;
  for (int i = tid; i < K * VS; i += NT) S[i] = s0[(i / VS) * K + i % VS];
  if (tid < K) uS[tid] = p.u[h * K + tid];

  // the score tile of this thread: (ti, si), si <= ti, rows 4ti.., columns 4si..
  int ti = -1, si = 0;
  if (tid < N_TILES) {
    ti = 0;
    while ((ti + 1) * (ti + 2) / 2 <= tid) ++ti;
    si = tid - ti * (ti + 1) / 2;
  }
  // out rows (paired so the causal loop has one length) and state rows; columns cg + 16 c
  const int rg = tid / 16;
  const int cg = tid % 16;
  const int tA = 2 * rg;
  const int orow[4] = {tA, tA + 1, 62 - tA, 63 - tA};

  float s_new[4][TV];

  for (int ch = 0; ch < n_chunks; ++ch) {
    const int t0 = ch * C;
    const int nv = min(C, p.T - t0);  // valid rows of this chunk

    // ---- load: r, k transposed; logw * log2(e) after a zero column; v as is
    // every global load of the chunk is issued before the first store, so the
    // block waits for memory once a chunk, not once a row
    constexpr int NL = C * K / NT;   // rows of r, k, logw a thread loads (column kk)
    constexpr int NV = C * VS / NT;  // elements of v a thread loads
    const int kk_l = tid % K;
    const int t_l = tid / K;
    float rv[NL], kv[NL], wv[NL], vv[NV];
#pragma unroll
    for (int j = 0; j < NL; ++j) {
      const int t = t_l + j * (NT / K);
      rv[j] = kv[j] = wv[j] = 0.f;
      if (t < nv) {
        const long long row = t0 + t;
        rv[j] = to_f(rb[row * p.r_st + kk_l]);
        kv[j] = to_f(kb[row * p.k_st + kk_l]);
        wv[j] = wb[row * p.w_st + kk_l];
      }
    }
#pragma unroll
    for (int j = 0; j < NV; ++j) {
      const int t = (tid + j * NT) / VS;
      vv[j] = t < nv ? to_f(vb[static_cast<long long>(t0 + t) * p.v_st + tid % VS]) : 0.f;
    }
#pragma unroll
    for (int j = 0; j < NL; ++j) {
      const int t = t_l + j * (NT / K);
      rT[kk_l * LD + t] = rv[j];
      kT[kk_l * LD + t] = kv[j];
      cT[kk_l * LD + 1 + t] = wv[j] * LOG2E;
    }
#pragma unroll
    for (int j = 0; j < NV; ++j) vS[tid + j * NT] = vv[j];
    if (tid < K) cT[tid * LD] = 0.f;
    __syncthreads();

    // ---- inclusive cumulative sum of logw along t, per k row: 4 lanes a row
    {
      const int kk = tid >> 2;
      const int q = tid & 3;
      float* row = cT + kk * LD + 1 + 16 * q;
      float x[16];
      float run = 0.f;
#pragma unroll
      for (int i = 0; i < 16; ++i) {
        run += row[i];
        x[i] = run;
      }
      float incl = run;
      float up = __shfl_up_sync(0xffffffffu, incl, 1, 4);
      if (q >= 1) incl += up;
      up = __shfl_up_sync(0xffffffffu, incl, 2, 4);
      if (q >= 2) incl += up;
      const float base = incl - run;
#pragma unroll
      for (int i = 0; i < 16; ++i) row[i] = x[i] + base;
      if (q == 3) clast[kk] = incl;
    }
    __syncthreads();

    // ---- pairwise scores (strictly lower triangle), and the diagonal bonus
    if (ti >= 0) {
      const int ta = 4 * ti;
      const int sa = 4 * si;
      float acc[4][4];
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int s = 0; s < 4; ++s) acc[a][s] = 0.f;
#pragma unroll 4
      for (int kk = 0; kk < K; ++kk) {
        const float* rr = rT + kk * LD;
        const float* kr = kT + kk * LD;
        const float* cr = cT + kk * LD;
        float rv[4], cx[4], kv[4], cs[4];
#pragma unroll
        for (int a = 0; a < 4; ++a) {
          rv[a] = rr[ta + a];
          cx[a] = cr[ta + a];      // clw_ex[t]
          kv[a] = kr[sa + a];
          cs[a] = cr[sa + 1 + a];  // clw[s]
        }
#pragma unroll
        for (int a = 0; a < 4; ++a)
#pragma unroll
          for (int s = 0; s < 4; ++s)
            acc[a][s] = fmaf(rv[a] * kv[s], ex2(fminf(cx[a] - cs[s], 0.f)), acc[a][s]);
      }
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int s = 0; s < 4; ++s)
          scT[(sa + s) * LD + ta + a] = (sa + s < ta + a) ? acc[a][s] : 0.f;
    } else if (tid < N_TILES + C) {
      const int t = tid - N_TILES;
      float d = 0.f;
      for (int kk = 0; kk < K; ++kk) d = fmaf(rT[kk * LD + t] * uS[kk], kT[kk * LD + t], d);
      dsum[t] = d;
    }
    __syncthreads();

    // ---- decay r to the chunk start and k to the chunk end, in place
    for (int i = tid; i < K * C; i += NT) {
      const int kk = i / C;
      const int t = i % C;
      rT[kk * LD + t] *= ex2(cT[kk * LD + t]);
      kT[kk * LD + t] *= ex2(clast[kk] - cT[kk * LD + 1 + t]);
    }
    __syncthreads();

    // ---- out = scores.v + dsum * v + (r e^{clw_ex}).S
    {
      float acc[4][TV];
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        const float ds = dsum[orow[a]];
#pragma unroll
        for (int c = 0; c < TV; ++c) acc[a][c] = ds * vS[orow[a] * VS + cg + 16 * c];
      }
      // rows tA, tA+1 need s <= tA+1 and rows 62-tA, 63-tA need s <= 63-tA;
      // the scores past the diagonal inside those ranges are the stored zeros
      for (int s = 0; s < tA + 2; ++s) {
        float vv[TV];
#pragma unroll
        for (int c = 0; c < TV; ++c) vv[c] = vS[s * VS + cg + 16 * c];
#pragma unroll
        for (int a = 0; a < 4; ++a) {
          const float sc = scT[s * LD + orow[a]];
#pragma unroll
          for (int c = 0; c < TV; ++c) acc[a][c] = fmaf(sc, vv[c], acc[a][c]);
        }
      }
      for (int s = tA + 2; s < 64 - tA; ++s) {
        float vv[TV];
#pragma unroll
        for (int c = 0; c < TV; ++c) vv[c] = vS[s * VS + cg + 16 * c];
#pragma unroll
        for (int a = 2; a < 4; ++a) {
          const float sc = scT[s * LD + orow[a]];
#pragma unroll
          for (int c = 0; c < TV; ++c) acc[a][c] = fmaf(sc, vv[c], acc[a][c]);
        }
      }
#pragma unroll 4
      for (int kk = 0; kk < K; ++kk) {
        float sv[TV];
#pragma unroll
        for (int c = 0; c < TV; ++c) sv[c] = S[kk * VS + cg + 16 * c];
#pragma unroll
        for (int a = 0; a < 4; ++a) {
          const float rd = rT[kk * LD + orow[a]];
#pragma unroll
          for (int c = 0; c < TV; ++c) acc[a][c] = fmaf(rd, sv[c], acc[a][c]);
        }
      }
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        if (orow[a] < nv) {
          float* o = p.out + ((static_cast<long long>(b) * p.T + t0 + orow[a]) * p.H + h) * K + v0 + cg;
#pragma unroll
          for (int c = 0; c < TV; ++c) o[16 * c] = acc[a][c];
        }
      }
    }

    // ---- S' = e^{clw_C} S + (k e^{clw_C - clw})^T . v, rows 4rg.., into registers
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      const int kk = 4 * rg + a;
      const float dk = ex2(clast[kk]);
#pragma unroll
      for (int c = 0; c < TV; ++c) s_new[a][c] = dk * S[kk * VS + cg + 16 * c];
    }
#pragma unroll 4
    for (int s = 0; s < C; ++s) {
      float vv[TV];
#pragma unroll
      for (int c = 0; c < TV; ++c) vv[c] = vS[s * VS + cg + 16 * c];
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        const float kd = kT[(4 * rg + a) * LD + s];
#pragma unroll
        for (int c = 0; c < TV; ++c) s_new[a][c] = fmaf(kd, vv[c], s_new[a][c]);
      }
    }
    __syncthreads();  // every read of S and of this chunk's tiles is done
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int c = 0; c < TV; ++c) S[(4 * rg + a) * VS + cg + 16 * c] = s_new[a][c];
    // the next chunk's first __syncthreads orders these stores before any read
  }

  float* so = p.s_out + bh * K * K + v0;
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int c = 0; c < TV; ++c) so[(4 * rg + a) * K + cg + 16 * c] = s_new[a][c];
}

template <typename T, int VS>
int launch(const WkvParams& p, cudaStream_t stream) {
  const int smem = smem_floats<VS>() * static_cast<int>(sizeof(float));
  cudaError_t err = cudaFuncSetAttribute(wkv6_kernel<T, VS>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid(K / VS, p.H, p.B);
  wkv6_kernel<T, VS><<<grid, NT, smem, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
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
// order; the last dim of each is contiguous. u, state0, out and state_out
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
