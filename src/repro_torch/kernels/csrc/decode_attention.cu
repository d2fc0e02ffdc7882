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
// What the design does about it: nothing but streaming. Each kv row of one
// (batch, kv head) is a contiguous 2*D bytes; D/8 lanes read it with 16-byte
// loads and every thread keeps several rows in flight before it touches them.
// The (G,D) query tile is too small for tensor cores to matter: scores and
// p.v are CUDA-core FMAs in f32. The TPU grid (B,KVH,nk) is sequential in nk;
// here B*KVH blocks alone would leave half the SMs idle at small batch, so
// the KV sweep is split over gridDim.x blocks, each writing a partial
// (acc, m, l), and a second small kernel combines them. Slots at or past
// kv_len are never read: whole splits past it exit at once, the tail is
// masked. Smax need not divide anything.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <stdint.h>

namespace {

constexpr float NEG_INF = -1e30f;
constexpr int NWARPS = 4;
constexpr int NTHREADS = NWARPS * 32;

struct DecodeParams {
  const void* q;      // (B, H, D) contiguous
  const void* k;      // (B, Smax, KVH, D) by strides, last dim contiguous
  const void* v;
  const int* kv_len;  // 1 element, device
  void* out;          // (B, H, D) contiguous
  float* part_acc;    // (B, H, n_split, D)
  float* part_m;      // (B, H, n_split)
  float* part_l;      // (B, H, n_split)
  long long k_sb, k_ss, k_sh;
  long long v_sb, v_ss, v_sh;
  int B, H, KVH, G, Smax, n_gt;
  float scale;
};

template <typename T>
struct Cvt;

template <>
struct Cvt<__nv_bfloat16> {
  static __device__ __forceinline__ void unpack8(const uint4& raw, float (&f)[8]) {
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 x = __bfloat1622float2(h[i]);
      f[2 * i] = x.x;
      f[2 * i + 1] = x.y;
    }
  }
  static __device__ __forceinline__ __nv_bfloat16 from_float(float x) {
    return __float2bfloat16(x);
  }
};

template <>
struct Cvt<__half> {
  static __device__ __forceinline__ void unpack8(const uint4& raw, float (&f)[8]) {
    const __half2* h = reinterpret_cast<const __half2*>(&raw);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 x = __half22float2(h[i]);
      f[2 * i] = x.x;
      f[2 * i + 1] = x.y;
    }
  }
  static __device__ __forceinline__ __half from_float(float x) { return __float2half(x); }
};

// One block: one split of the KV sweep of one (batch, kv head, tile of GT
// query heads). Lanes are laid out as (row group, 16-byte chunk of D); each
// row group runs its own online softmax over the rows it visits and the
// groups are merged through shared memory at the end.
template <typename T, int D, int GT>
__global__ void __launch_bounds__(NTHREADS) decode_partial_kernel(const DecodeParams p) {
  constexpr int LPR = D / 8;          // lanes per kv row
  constexpr int RPW = 32 / LPR;       // kv rows per warp per load
  constexpr int NG = NWARPS * RPW;    // row groups per block
  constexpr int U = (GT >= 8) ? 2 : 4;  // rows in flight per thread

  __shared__ float s_acc[NG][GT][D];
  __shared__ float s_m[NG][GT];
  __shared__ float s_l[NG][GT];

  const int split = blockIdx.x;
  const int n_split = gridDim.x;
  const int kvh = blockIdx.y / p.n_gt;
  const int g0 = (blockIdx.y % p.n_gt) * GT;  // first query head of this tile, within the group
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int c = lane % LPR;                 // 16-byte chunk of the row
  const int gid = warp * RPW + lane / LPR;  // row group

  const int kv_len = min(p.kv_len[0], p.Smax);
  const int chunk = (p.Smax + n_split - 1) / n_split;
  const int start = split * chunk;
  const int end = min(kv_len, start + chunk);

  const T* kb = static_cast<const T*>(p.k) + b * p.k_sb + kvh * p.k_sh + c * 8;
  const T* vb = static_cast<const T*>(p.v) + b * p.v_sb + kvh * p.v_sh + c * 8;

  float qv[GT][8];
  float acc[GT][8];
  float m[GT];
  float l[GT];
#pragma unroll
  for (int g = 0; g < GT; ++g) {
    m[g] = NEG_INF;
    l[g] = 0.f;
    uint4 raw = make_uint4(0u, 0u, 0u, 0u);
    if (g0 + g < p.G) {
      const long long head = static_cast<long long>(b) * p.H + kvh * p.G + g0 + g;
      raw = *reinterpret_cast<const uint4*>(static_cast<const T*>(p.q) + head * D + c * 8);
    }
    Cvt<T>::unpack8(raw, qv[g]);
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      qv[g][i] *= p.scale;
      acc[g][i] = 0.f;
    }
  }

  for (int base = start; base < end; base += NG * U) {
    uint4 kraw[U];
    uint4 vraw[U];
    bool ok[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const long long row = base + u * NG + gid;
      ok[u] = row < end;
      kraw[u] = make_uint4(0u, 0u, 0u, 0u);
      vraw[u] = make_uint4(0u, 0u, 0u, 0u);
      if (ok[u]) {
        kraw[u] = *reinterpret_cast<const uint4*>(kb + row * p.k_ss);
        vraw[u] = *reinterpret_cast<const uint4*>(vb + row * p.v_ss);
      }
    }

    float s[U][GT];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      float kf[8];
      Cvt<T>::unpack8(kraw[u], kf);
#pragma unroll
      for (int g = 0; g < GT; ++g) {
        float dot = 0.f;
#pragma unroll
        for (int i = 0; i < 8; ++i) dot = fmaf(qv[g][i], kf[i], dot);
#pragma unroll
        for (int off = LPR / 2; off > 0; off >>= 1)
          dot += __shfl_xor_sync(0xffffffffu, dot, off);
        s[u][g] = ok[u] ? dot : NEG_INF;
      }
    }

    float vf[U][8];
#pragma unroll
    for (int u = 0; u < U; ++u) Cvt<T>::unpack8(vraw[u], vf[u]);

#pragma unroll
    for (int g = 0; g < GT; ++g) {
      float mx = s[0][g];
#pragma unroll
      for (int u = 1; u < U; ++u) mx = fmaxf(mx, s[u][g]);
      const float mn = fmaxf(m[g], mx);
      const float corr = __expf(m[g] - mn);
      m[g] = mn;
      l[g] *= corr;
#pragma unroll
      for (int i = 0; i < 8; ++i) acc[g][i] *= corr;
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const float pu = ok[u] ? __expf(s[u][g] - mn) : 0.f;
        l[g] += pu;
#pragma unroll
        for (int i = 0; i < 8; ++i) acc[g][i] = fmaf(pu, vf[u][i], acc[g][i]);
      }
    }
  }

  // ---- merge the row groups of this block
#pragma unroll
  for (int g = 0; g < GT; ++g) {
    if (c == 0) {
      s_m[gid][g] = m[g];
      s_l[gid][g] = l[g];
    }
#pragma unroll
    for (int i = 0; i < 8; ++i) s_acc[gid][g][c * 8 + i] = acc[g][i];
  }
  __syncthreads();

  for (int idx = tid; idx < GT * D; idx += NTHREADS) {
    const int g = idx / D;
    const int d = idx % D;
    if (g0 + g >= p.G) continue;
    float mt = NEG_INF;
    for (int j = 0; j < NG; ++j) mt = fmaxf(mt, s_m[j][g]);
    float lt = 0.f;
    float at = 0.f;
    for (int j = 0; j < NG; ++j) {
      const float w = __expf(s_m[j][g] - mt);
      lt += w * s_l[j][g];
      at += w * s_acc[j][g][d];
    }
    const long long head = static_cast<long long>(b) * p.H + kvh * p.G + g0 + g;
    if (n_split == 1) {
      static_cast<T*>(p.out)[head * D + d] = Cvt<T>::from_float(at / fmaxf(lt, 1e-30f));
    } else {
      const long long slot = head * n_split + split;
      p.part_acc[slot * D + d] = at;
      if (d == 0) {
        p.part_m[slot] = mt;
        p.part_l[slot] = lt;
      }
    }
  }
}

// One block per (batch, head), one thread per output element: combine the
// partial (acc, m, l) of the splits.
template <typename T>
__global__ void decode_combine_kernel(const DecodeParams p, int n_split, int D) {
  const long long head = blockIdx.x;
  const int d = threadIdx.x;
  float mt = NEG_INF;
  for (int s = 0; s < n_split; ++s) mt = fmaxf(mt, p.part_m[head * n_split + s]);
  float lt = 0.f;
  float at = 0.f;
  for (int s = 0; s < n_split; ++s) {
    const long long slot = head * n_split + s;
    const float w = __expf(p.part_m[slot] - mt);
    lt += w * p.part_l[slot];
    at += w * p.part_acc[slot * D + d];
  }
  static_cast<T*>(p.out)[head * D + d] = Cvt<T>::from_float(at / fmaxf(lt, 1e-30f));
}

template <typename T, int D, int GT>
int launch(const DecodeParams& p, int n_split, cudaStream_t stream) {
  dim3 grid(n_split, p.KVH * p.n_gt, p.B);
  decode_partial_kernel<T, D, GT><<<grid, NTHREADS, 0, stream>>>(p);
  int err = static_cast<int>(cudaGetLastError());
  if (err != 0 || n_split == 1) return err;
  decode_combine_kernel<T><<<p.B * p.H, D, 0, stream>>>(p, n_split, D);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int D>
int launch_gt(DecodeParams& p, int gt, int n_split, cudaStream_t stream) {
  p.n_gt = (p.G + gt - 1) / gt;
  switch (gt) {
    case 8: return launch<T, D, 8>(p, n_split, stream);
    case 4: return launch<T, D, 4>(p, n_split, stream);
    case 2: return launch<T, D, 2>(p, n_split, stream);
    case 1: return launch<T, D, 1>(p, n_split, stream);
    default: return -1;
  }
}

}  // namespace

// Cache strides are in elements: k b,s,kvh | v b,s,kvh. dtype: 0 = bf16,
// 1 = f16. gt = query heads of one kv head handled by one block (1, 2, 4 or
// 8; a group larger than gt takes several blocks). part_* are scratch of
// n_split partial results per (batch, head), unused when n_split == 1.
// Returns cudaGetLastError(), or -1 for a head_dim, type or gt that has no
// instantiation.
extern "C" int decode_attention_launch(
    const void* q, const void* k, const void* v, const int* kv_len, void* out,
    float* part_acc, float* part_m, float* part_l, const long long* strides,
    int B, int H, int KVH, int D, int Smax, int gt, int n_split, float scale, int dtype,
    void* stream) {
  DecodeParams p;
  p.q = q; p.k = k; p.v = v; p.kv_len = kv_len; p.out = out;
  p.part_acc = part_acc; p.part_m = part_m; p.part_l = part_l;
  p.k_sb = strides[0]; p.k_ss = strides[1]; p.k_sh = strides[2];
  p.v_sb = strides[3]; p.v_ss = strides[4]; p.v_sh = strides[5];
  p.B = B; p.H = H; p.KVH = KVH; p.G = H / KVH; p.Smax = Smax; p.n_gt = 1;
  p.scale = scale;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && D == 64) return launch_gt<__nv_bfloat16, 64>(p, gt, n_split, st);
  if (dtype == 0 && D == 128) return launch_gt<__nv_bfloat16, 128>(p, gt, n_split, st);
  if (dtype == 1 && D == 64) return launch_gt<__half, 64>(p, gt, n_split, st);
  if (dtype == 1 && D == 128) return launch_gt<__half, 128>(p, gt, n_split, st);
  return -1;
}
