// Attention of one query token over a cached K/V, the TrOCR decoder's
// greedy step: for each row b and head h,
//   s[t]   = (q[b,h] . k[b,t,h]) * scale          for the live t
//   w[t]   = round_to_T(softmax(s)[t])
//   out    = round_to_T(sum_t w[t] * v[b,t,h])
// with the dot products, the softmax and the P.V sum in float32, as the
// plain version (vtd_tpu_torch/ops/decode_attention.py) computes them; only
// the order of the float32 sums differs. Positions 0..pos are live when a
// device-held `pos` (int64 [1]) is given, all T otherwise; the masked ones
// carry weight exactly 0 in the plain version too.
//
// Replaces no TPU kernel: the JAX package leaves this attention to XLA
// (vtd_tpu/models/trocr.py, Attention). It was added because on the card
// the plain version moves the chunk's bf16 cross K/V ([16, 577, 16, 64],
// 18.9 MB a layer) about six times a step: K cast to float32, copied
// contiguous again for the batched product and read a third time by a
// float32 GEMM, V copied contiguous before P.V; some 227 MB a layer and
// ten launches an attention.
//
// What bounds it on an H100: device bytes. It has to read K and V once,
// B*T*H*hd*2 elements of T: at B = 16, T = 577, H = 16, hd = 64 in bf16
// that is 37.8 MB, 11.3 us at 3.35 TB/s. q and the output are 4 KB each.
//
// The design, for small batches over a long cache:
//   * each (row, head) pair gets a thread-block cluster of C blocks, and
//     block r of it takes positions [r*share, (r+1)*share), share =
//     ceil(T / C). The wrapper picks C (1, 2, 4 or 8) from the shape
//     (ops/decode_attention.py:cluster_size): the least that puts about
//     two blocks on every SM, but no more than leaves each block a full
//     pass of its loop (128 positions at hd 64 in bf16). So C = 2 for a
//     full chunk's cross-attention (B*H = 256, T = 577), 4 for a one-crop
//     tail, and 1 for the 50-slot self-attention cache, which then needs
//     no exchange. A block sums its positions in an order that does not
//     depend on T, so wherever C is 1 the eager loop's [:, :s+1] slices of
//     that cache sum as the graphs' masked 50 slots do, bit for bit.
//   * K and V are read in their stored layout [B, T, H, hd] (row stride an
//     argument, so a prefix of the rows or of the positions needs no copy):
//     one position's row of one head is hd contiguous elements, read by a
//     group of G lanes with one 16-byte load each (G = hd*sizeof(T)/16
//     rounded up to a power of two; 8 lanes, 128 bytes at hd 64 in bf16).
//     Every thread issues kUnroll loads before it uses one, so about 16 KB
//     a block is in flight. q sits in registers.
//   * the scores of the block's share go to shared memory; the block's
//     maximum, then its sum of exponentials, are exchanged across the
//     cluster through distributed shared memory. So each block rounds its
//     weights to T exactly as the plain version does (that needs the
//     global max and sum) with no second pass over K.
//   * P.V: each lane sums weight x V over its group's positions, the
//     groups of a warp and then the warps of a block are summed, and the C
//     blocks' partial sums [hd] are read across the cluster; block r
//     writes the output elements d with d % C == r.
// What it leaves on the table: V is read only after the cluster has its
// sum (the blocks' phases overlap across the several blocks an SM holds,
// not within one); three cluster barriers per launch.
#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kUnroll = 4;  // loads a thread issues before it uses one
constexpr int kMaxHd = 128;
constexpr int kMaxCluster = 8;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kSmemLimit = 232448;  // dynamic shared memory a block can have
constexpr int kDefaultSmem = 48 * 1024;

// dtype codes of the C interface
constexpr int kFloat32 = 0, kBFloat16 = 1, kFloat16 = 2;

struct Params {
  const void* q;      // [B, H*hd]
  const void* k;      // [B, T, H, hd], row stride k_row elements
  const void* v;      // [B, T, H, hd], row stride v_row elements
  void* out;          // [B, H*hd]
  const long long* pos;  // int64 [1] or null
  long long k_row, v_row;
  int T, H, hd, share;
  float scale;
};

// 16 bytes of T -> float
template <typename T>
struct Vec;

template <>
struct Vec<float> {
  static constexpr int N = 4;
  __device__ static void unpack(const uint4& r, float (&f)[N]) {
    f[0] = __uint_as_float(r.x);
    f[1] = __uint_as_float(r.y);
    f[2] = __uint_as_float(r.z);
    f[3] = __uint_as_float(r.w);
  }
  __device__ static float round(float x) { return x; }
  __device__ static void store(float* p, float x) { *p = x; }
};

template <>
struct Vec<__nv_bfloat16> {
  static constexpr int N = 8;
  __device__ static void unpack(const uint4& r, float (&f)[N]) {
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&r);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 x = __bfloat1622float2(h[i]);
      f[2 * i] = x.x;
      f[2 * i + 1] = x.y;
    }
  }
  __device__ static float round(float x) {
    return __bfloat162float(__float2bfloat16_rn(x));
  }
  __device__ static void store(__nv_bfloat16* p, float x) {
    *p = __float2bfloat16_rn(x);
  }
};

template <>
struct Vec<__half> {
  static constexpr int N = 8;
  __device__ static void unpack(const uint4& r, float (&f)[N]) {
    const __half2* h = reinterpret_cast<const __half2*>(&r);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 x = __half22float2(h[i]);
      f[2 * i] = x.x;
      f[2 * i + 1] = x.y;
    }
  }
  __device__ static float round(float x) {
    return __half2float(__float2half_rn(x));
  }
  __device__ static void store(__half* p, float x) { *p = __float2half_rn(x); }
};

struct Max {
  __device__ float operator()(float a, float b) const { return fmaxf(a, b); }
};
struct Sum {
  __device__ float operator()(float a, float b) const { return a + b; }
};

// x reduced over the block, returned to every thread; `red` holds kWarps
// floats and is free again on return.
template <class Op>
__device__ float block_reduce(float x, float* red, Op op) {
#pragma unroll
  for (int off = 16; off > 0; off /= 2) x = op(x, __shfl_xor_sync(kFull, x, off));
  if (threadIdx.x % 32 == 0) red[threadIdx.x / 32] = x;
  __syncthreads();
  x = red[0];
#pragma unroll
  for (int w = 1; w < kWarps; ++w) x = op(x, red[w]);
  __syncthreads();
  return x;
}

template <typename T, int G>
__global__ void __launch_bounds__(kThreads)
    decode_attention_kernel(const Params p) {
  using V = Vec<T>;
  constexpr int N = V::N;
  constexpr int P = kThreads / G;  // positions a block reads at once
  extern __shared__ float s_w[];   // the share's scores, then weights
  __shared__ float s_warp[kWarps][kMaxHd];
  __shared__ float s_part[kMaxHd];  // the block's P.V sum, read by the cluster
  __shared__ float s_red[kWarps];
  __shared__ float s_max, s_sum;

  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int C = gridDim.x;  // the cluster spans the grid's x dimension
  const int h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, lane = tid % G, group = tid / G;
  const bool active = lane * N < p.hd;

  int live = p.T;
  if (p.pos != nullptr) {
    const long long upto = *p.pos + 1;
    live = upto < 0 ? 0 : (upto < p.T ? static_cast<int>(upto) : p.T);
  }
  const int t0 = rank * p.share;
  const int n = max(min(t0 + p.share, live) - t0, 0);

  const long long step = static_cast<long long>(p.H) * p.hd / N;  // uint4s
  const long long col = (static_cast<long long>(h) * p.hd) / N + lane;
  const uint4* kb = reinterpret_cast<const uint4*>(
                        static_cast<const T*>(p.k) + b * p.k_row) +
                    col + t0 * step;
  const uint4* vb = reinterpret_cast<const uint4*>(
                        static_cast<const T*>(p.v) + b * p.v_row) +
                    col + t0 * step;

  float qf[N];
  {
    uint4 r = make_uint4(0, 0, 0, 0);
    if (active)
      r = __ldg(reinterpret_cast<const uint4*>(
                    static_cast<const T*>(p.q) +
                    static_cast<long long>(b) * p.H * p.hd) +
                col);
    V::unpack(r, qf);
  }

  // scores of the share
  float m = -INFINITY;
  for (int base = 0; base < n; base += P * kUnroll) {
    uint4 r[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int i = base + u * P + group;
      r[u] = (active && i < n) ? __ldg(kb + i * step) : make_uint4(0, 0, 0, 0);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      float f[N];
      V::unpack(r[u], f);
      float d = 0.f;
#pragma unroll
      for (int j = 0; j < N; ++j) d = fmaf(qf[j], f[j], d);
#pragma unroll
      for (int off = G / 2; off > 0; off /= 2)
        d += __shfl_xor_sync(kFull, d, off);
      const int i = base + u * P + group;
      if (lane == 0 && i < n) {
        const float s = d * p.scale;
        s_w[i] = s;
        m = fmaxf(m, s);
      }
    }
  }
  m = block_reduce(m, s_red, Max());
  if (tid == 0) s_max = m;
  cluster.sync();
  float gmax = -INFINITY;
  for (int r = 0; r < C; ++r) gmax = fmaxf(gmax, *cluster.map_shared_rank(&s_max, r));

  // exponentials and their sum over the cluster
  float sum = 0.f;
  for (int i = tid; i < n; i += kThreads) {
    const float e = expf(s_w[i] - gmax);
    s_w[i] = e;
    sum += e;
  }
  sum = block_reduce(sum, s_red, Sum());
  if (tid == 0) s_sum = sum;
  cluster.sync();
  float gsum = 0.f;
  for (int r = 0; r < C; ++r) gsum += *cluster.map_shared_rank(&s_sum, r);
  for (int i = tid; i < n; i += kThreads) s_w[i] = V::round(s_w[i] / gsum);
  __syncthreads();

  // weights x V
  float acc[N];
#pragma unroll
  for (int j = 0; j < N; ++j) acc[j] = 0.f;
  for (int base = 0; base < n; base += P * kUnroll) {
    uint4 r[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int i = base + u * P + group;
      r[u] = (active && i < n) ? __ldg(vb + i * step) : make_uint4(0, 0, 0, 0);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int i = base + u * P + group;
      if (i < n) {
        float f[N];
        V::unpack(r[u], f);
        const float w = s_w[i];
#pragma unroll
        for (int j = 0; j < N; ++j) acc[j] = fmaf(w, f[j], acc[j]);
      }
    }
  }
#pragma unroll
  for (int j = 0; j < N; ++j) {
#pragma unroll
    for (int off = G; off < 32; off *= 2)
      acc[j] += __shfl_xor_sync(kFull, acc[j], off);
  }
  if (tid % 32 < G && active) {
#pragma unroll
    for (int j = 0; j < N; ++j) s_warp[tid / 32][lane * N + j] = acc[j];
  }
  __syncthreads();
  for (int d = tid; d < p.hd; d += kThreads) {
    float x = s_warp[0][d];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) x += s_warp[w][d];
    s_part[d] = x;
  }
  cluster.sync();
  T* out = static_cast<T*>(p.out) + (static_cast<long long>(b) * p.H + h) * p.hd;
  for (int d = rank + tid * C; d < p.hd; d += kThreads * C) {
    float x = 0.f;
    for (int r = 0; r < C; ++r) x += cluster.map_shared_rank(s_part, r)[d];
    V::store(out + d, x);
  }
  // no block leaves while another may still read its shared memory
  cluster.sync();
}

template <typename T, int G>
cudaError_t launch(const Params& p, int B, int cluster, size_t smem,
                   cudaStream_t stream) {
  auto kernel = decode_attention_kernel<T, G>;
  if (smem > kDefaultSmem) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cluster, p.H, B);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, kernel, p);
}

// Lanes a position's row takes: its 16-byte loads, rounded up to a power
// of two.
int group_lanes(int hd, int esize) {
  const int loads = hd * esize / 16;
  int g = 2;
  while (g < loads) g *= 2;
  return g;
}

template <typename T>
cudaError_t launch_lanes(Params p, int B, int cluster, cudaStream_t stream) {
  const int G = group_lanes(p.hd, sizeof(T));
  p.share = (p.T + cluster - 1) / cluster;
  const size_t smem = static_cast<size_t>(p.share) * sizeof(float);
  if (smem > static_cast<size_t>(kSmemLimit - 8 * 1024))  // and static
    return cudaErrorInvalidValue;
  if (G == 4) return launch<T, 4>(p, B, cluster, smem, stream);
  if (G == 8) return launch<T, 8>(p, B, cluster, smem, stream);
  if (G == 16) return launch<T, 16>(p, B, cluster, smem, stream);
  // hd 16 in a 16-bit type; hd above 64 in float32
  if constexpr (sizeof(T) == 2)
    return launch<T, 2>(p, B, cluster, smem, stream);
  else
    return launch<T, 32>(p, B, cluster, smem, stream);
}

bool aligned(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

}  // namespace

// q [B, H*hd] contiguous, k and v [B, T, H, hd] with contiguous [T, H, hd]
// inner dimensions and row strides k_row / v_row (elements), out [B, H*hd]
// (written), pos an int64 [1] on the device or null, all of the dtype
// `dtype` (0 float32, 1 bfloat16, 2 float16). One launch of B*H clusters of
// `cluster` blocks on `stream`; does not synchronise. Returns a CUDA error
// code: cudaErrorInvalidValue for a shape, dtype, cluster size or
// alignment the kernel does not take (hd a multiple of 8 in [16, 128],
// 16-byte aligned pointers and row strides, cluster 1, 2, 4 or 8 and at
// most T).
extern "C" int vtd_decode_attention(const void* q, const void* k,
                                    const void* v, void* out, const void* pos,
                                    long long k_row, long long v_row, int B,
                                    int T, int H, int hd, int dtype,
                                    int cluster, float scale, void* stream) {
  const int esize = dtype == kFloat32 ? 4 : 2;
  if ((dtype != kFloat32 && dtype != kBFloat16 && dtype != kFloat16) ||
      B < 1 || B > 65535 || H < 1 || H > 65535 || T < 1 || hd < 16 ||
      hd > kMaxHd || hd % 8 != 0 || cluster < 1 || cluster > kMaxCluster ||
      (cluster & (cluster - 1)) != 0 || cluster > T || !aligned(q) ||
      !aligned(k) || !aligned(v) || !aligned(out) ||
      (k_row * esize) % 16 != 0 || (v_row * esize) % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  Params p;
  p.q = q;
  p.k = k;
  p.v = v;
  p.out = out;
  p.pos = static_cast<const long long*>(pos);
  p.k_row = k_row;
  p.v_row = v_row;
  p.T = T;
  p.H = H;
  p.hd = hd;
  p.share = 0;  // set with the block's geometry
  p.scale = scale;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  if (dtype == kFloat32)
    e = launch_lanes<float>(p, B, cluster, s);
  else if (dtype == kBFloat16)
    e = launch_lanes<__nv_bfloat16>(p, B, cluster, s);
  else
    e = launch_lanes<__half>(p, B, cluster, s);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}
