// `iters` Jacobi sweeps of the 8-neighbour minimum on a batch of label maps.
//
// Replaces the TPU kernel vtd_tpu/ops/pallas_kernels.py:_sweep_kernel
// (wrapper neighbor_min_sweeps). One sweep is
//   lbl = where(fg, min over the 3x3 window (self included) of
//                   where(fg, lbl, 2^30), lbl)
// with 2^30 beyond the map edge; every sweep reads the map as the previous
// sweep left it. Background cells keep their labels, and a foreground
// cell's own label is in its window, so a label never rises.
//
// What bounds it on an H100: memory traffic. The function has to read the
// mask (1 B) and the labels (4 B) and write the labels (4 B) once per cell
// whatever `iters` is: 16 x 320 x 320 x 9 B = 14.7 MB, 4.4 us at 3.35 TB/s;
// the integer work (iters x 9 min per cell) is far below that.
//
// The TPU kernel holds a whole map in VMEM (a 320x320 int32 map is 400 KB;
// a block here has at most 227 KB of shared memory). Here one thread block
// owns one kTile x kTile output tile of one map. It loads the tile plus a
// halo of `iters` cells (masked labels and the mask) into shared memory,
// sweeps `iters` times between two shared buffers, and writes the tile's
// centre, so the labels cross device memory once however many sweeps run:
//   * a halo cell at distance d from the window's edge is right after
//     sweep s only while d >= s (its missing neighbours were taken as 2^30),
//     so sweep s computes only the cells with d >= s; the centre has
//     d >= iters and is right after the last sweep;
//   * cells beyond the map edge are not "invalid": they are background
//     holding 2^30 in every sweep, which the load writes for them;
//   * the two buffers keep the sweep Jacobi: an in-place stencil would carry
//     a label further than one cell per sweep and break label equality.
// Shared memory is (kTile + 2*iters)^2 x 9 B; the wrapper refuses `iters`
// past the 227 KB limit. This is the simple, correct design; speed (halo
// re-reads are (1 + 2*iters/kTile)^2 of the tile, the stencil is not
// separated into a row and a column pass) is later work.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int32_t kBig = 1 << 30;  // sentinel, as in the reference kernel
constexpr int kTile = 32;
constexpr int kThreads = 256;

__global__ void sweeps_kernel(const uint8_t* __restrict__ fg,
                              const int32_t* __restrict__ labels,
                              int32_t* __restrict__ out, int H, int W,
                              int iters) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int S = kTile + 2 * iters;
  const int n = S * S;
  int32_t* cur = reinterpret_cast<int32_t*>(smem);
  int32_t* nxt = cur + n;
  uint8_t* on = reinterpret_cast<uint8_t*>(nxt + n);

  const long long base = (long long)blockIdx.z * H * W;
  const int r0 = blockIdx.y * kTile - iters;  // map row of window row 0
  const int c0 = blockIdx.x * kTile - iters;

  // masked labels: background and beyond-the-edge cells hold kBig
  for (int i = threadIdx.x; i < n; i += kThreads) {
    const int r = r0 + i / S;
    const int c = c0 + i % S;
    bool f = false;
    int32_t v = kBig;
    if (r >= 0 && r < H && c >= 0 && c < W) {
      const long long g = base + (long long)r * W + c;
      f = fg[g] != 0;
      if (f) v = labels[g];
    }
    on[i] = f;
    cur[i] = v;
  }
  __syncthreads();

  for (int s = 1; s <= iters; ++s) {
    const int side = S - 2 * s;  // cells still right after this sweep
    for (int i = threadIdx.x; i < side * side; i += kThreads) {
      const int p = (s + i / side) * S + s + i % side;
      int32_t m = kBig;
      if (on[p]) {
        const int32_t* q = cur + p - S - 1;
        m = min(min(q[0], q[1]), q[2]);
        q += S;
        m = min(m, min(min(q[0], q[1]), q[2]));
        q += S;
        m = min(m, min(min(q[0], q[1]), q[2]));
      }
      nxt[p] = m;
    }
    __syncthreads();
    int32_t* t = cur;
    cur = nxt;
    nxt = t;
  }

  for (int i = threadIdx.x; i < kTile * kTile; i += kThreads) {
    const int tr = i / kTile;
    const int tc = i % kTile;
    const int r = blockIdx.y * kTile + tr;
    const int c = blockIdx.x * kTile + tc;
    if (r >= H || c >= W) continue;
    const int p = (iters + tr) * S + iters + tc;
    const long long g = base + (long long)r * W + c;
    out[g] = on[p] ? cur[p] : labels[g];
  }
}

}  // namespace

// fg [B,H,W] uint8 (0/1), labels [B,H,W] int32 (read only), out [B,H,W]
// int32 (written). Launches on `stream`, does not synchronise, returns the
// CUDA error of the set-up or the launch (0 = launched).
extern "C" int vtd_neighbor_min_sweeps(const void* fg, const void* labels,
                                       void* out, int B, int H, int W,
                                       int iters, void* stream) {
  const size_t side = kTile + 2 * (size_t)iters;
  const size_t smem = side * side * 9;  // two int32 buffers and a byte mask
  cudaError_t err = cudaFuncSetAttribute(
      sweeps_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((W + kTile - 1) / kTile, (H + kTile - 1) / kTile, B);
  sweeps_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(fg), static_cast<const int32_t*>(labels),
      static_cast<int32_t*>(out), H, W, iters);
  return static_cast<int>(cudaGetLastError());
}
