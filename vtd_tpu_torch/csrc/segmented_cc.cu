// One round of segmented 8-connected label propagation on a batch of maps.
//
// Replaces the TPU kernel vtd_tpu/ops/pallas_kernels.py:_seg_round_kernel
// (wrapper segmented_cc_round). Only foreground cells change; background
// cells keep their labels. The round is, in this order:
//   1. min over the 8-neighbourhood (and self) of the foreground labels;
//   2. run minimum along every row (a run is a maximal stretch of
//      foreground cells; the map edge ends a run, nothing wraps);
//   3. min over the 8-neighbourhood again;
//   4. run minimum along every column;
//   5. with diag: run minimum along every main diagonal ((r,c)->(r+1,c+1)),
//      then along every anti-diagonal ((r,c)->(r+1,c-1)), the second
//      seeded from what the first left.
// The TPU kernel computes each run minimum as a forward and a reverse
// reach-doubling ladder; a run minimum is exact integer arithmetic, so any
// order of evaluation gives the same labels, label for label.
//
// What bounds it on an H100: memory traffic. A round has to read the
// foreground mask (1 B) and the labels (4 B) and write the labels (4 B)
// once per cell: 16 x 320 x 320 x 9 B = 14.7 MB, 4.4 us at 3.35 TB/s.
// The TPU design keeps the whole map in VMEM; a 320x320 int32 map is
// 400 KB, more than the 227 KB of shared memory a block can have, so here
// the labels stay in global memory (all B maps, 6.5 MB, sit in the 50 MB
// L2 between phases) and each phase is one kernel over all B maps:
//   * the 8-neighbour phases read one buffer and write the other (an
//     in-place stencil would propagate further than the reference);
//   * a line phase gives one warp to each row / column / diagonal. The
//     warp walks its line in chunks of 32 cells with a shuffle-based
//     segmented min-scan, forward and then back, carrying the run
//     minimum across chunks, and updates the line in place (lines of one
//     phase are disjoint). Rows are coalesced; columns and diagonals are
//     strided and lean on L2.
// Kernel boundaries separate the phases, so the whole card works on every
// phase of every map. This is the simple, correct design; a faster one
// (maps split over a thread-block cluster in distributed shared memory)
// is later work.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int32_t kBig = 1 << 30;  // sentinel, as in the reference
constexpr unsigned kFull = 0xffffffffu;
constexpr int kThreads = 256;

__global__ void min8_kernel(const uint8_t* __restrict__ fg,
                            const int32_t* __restrict__ src,
                            int32_t* __restrict__ dst, int B, int H, int W) {
  const long long total = (long long)B * H * W;
  const long long hw = (long long)H * W;
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
       i < total; i += (long long)gridDim.x * blockDim.x) {
    if (!fg[i]) {
      dst[i] = src[i];
      continue;
    }
    const long long base = (i / hw) * hw;
    const int r = (int)((i - base) / W);
    const int c = (int)((i - base) % W);
    int32_t m = kBig;
    for (int dr = -1; dr <= 1; ++dr) {
      const int rr = r + dr;
      if (rr < 0 || rr >= H) continue;
      for (int dc = -1; dc <= 1; ++dc) {
        const int cc = c + dc;
        if (cc < 0 || cc >= W) continue;
        const long long j = base + (long long)rr * W + cc;
        if (fg[j]) m = min(m, src[j]);
      }
    }
    dst[i] = m;
  }
}

struct Line {
  long long start;
  long long step;
  int len;
};

// kind 0 rows, 1 columns, 2 main diagonals, 3 anti-diagonals.
__device__ __forceinline__ Line line_of(int kind, int l, int H, int W) {
  Line L;
  if (kind == 0) {
    L.start = (long long)l * W; L.step = 1; L.len = W;
  } else if (kind == 1) {
    L.start = l; L.step = W; L.len = H;
  } else {
    // diagonals start on the top row (l < W) or the first/last column
    const int r0 = l < W ? 0 : l - W + 1;
    int c0;
    if (kind == 2) {
      c0 = l < W ? l : 0;
      L.step = W + 1;
      L.len = min(H - r0, W - c0);
    } else {
      c0 = l < W ? l : W - 1;
      L.step = W - 1;
      L.len = min(H - r0, c0 + 1);
    }
    L.start = (long long)r0 * W + c0;
  }
  return L;
}

__host__ __device__ __forceinline__ int num_lines(int kind, int H, int W) {
  return kind == 0 ? H : kind == 1 ? W : H + W - 1;
}

// One warp per line: run minimum of the foreground labels, in place.
__global__ void line_runmin_kernel(const uint8_t* __restrict__ fg,
                                   int32_t* __restrict__ lbl, int B, int H,
                                   int W, int kind) {
  const int lane = threadIdx.x & 31;
  const long long warp =
      (blockIdx.x * (long long)blockDim.x + threadIdx.x) >> 5;
  const int lines = num_lines(kind, H, W);
  if (warp >= (long long)B * lines) return;  // whole warp leaves together
  const long long map = warp / lines;
  const Line L = line_of(kind, (int)(warp % lines), H, W);
  const uint8_t* f = fg + map * H * W;
  int32_t* x = lbl + map * H * W;

  // forward: prefix minimum within each run
  int32_t carry = kBig;  // prefix min at the previous chunk's last cell
  for (int c0 = 0; c0 < L.len; c0 += 32) {
    const int i = c0 + lane;
    const long long off = L.start + (long long)i * L.step;
    const bool on = i < L.len && f[off];
    int32_t v = on ? x[off] : kBig;
    const unsigned bg = __ballot_sync(kFull, !on);
    const unsigned upto = bg & (lane == 31 ? kFull : ((2u << lane) - 1u));
    const int seg = upto ? 32 - __clz(upto) : 0;  // first lane of my run
    for (int d = 1; d < 32; d <<= 1) {
      const int32_t o = __shfl_up_sync(kFull, v, d);
      if (lane - d >= seg) v = min(v, o);
    }
    if (on && upto == 0) v = min(v, carry);
    if (on) x[off] = v;
    carry = __shfl_sync(kFull, v, 31);
  }
  // reverse: suffix minimum of the prefix minima = the run minimum
  carry = kBig;
  const int last = ((L.len - 1) / 32) * 32;
  for (int c0 = last; c0 >= 0; c0 -= 32) {
    const int i = c0 + lane;
    const long long off = L.start + (long long)i * L.step;
    const bool on = i < L.len && f[off];
    int32_t v = on ? x[off] : kBig;
    const unsigned bg = __ballot_sync(kFull, !on);
    const unsigned from = bg & ~((1u << lane) - 1u);  // lanes >= mine
    const int seg_end = from ? __ffs(from) - 1 : 32;   // first bg lane
    for (int d = 1; d < 32; d <<= 1) {
      const int32_t o = __shfl_down_sync(kFull, v, d);
      if (lane + d < seg_end) v = min(v, o);
    }
    if (on && from == 0) v = min(v, carry);
    if (on) x[off] = v;
    carry = __shfl_sync(kFull, v, 0);
  }
}

int blocks_for(long long threads) {
  return (int)((threads + kThreads - 1) / kThreads);
}

void run_lines(const uint8_t* fg, int32_t* lbl, int B, int H, int W,
               int kind, cudaStream_t s) {
  const long long warps = (long long)B * num_lines(kind, H, W);
  line_runmin_kernel<<<blocks_for(warps * 32), kThreads, 0, s>>>(
      fg, lbl, B, H, W, kind);
}

}  // namespace

// fg [B,H,W] uint8 (0/1), labels [B,H,W] int32 (read only),
// scratch and out [B,H,W] int32 (written); the result lands in out.
// Launches on `stream`, does not synchronise, returns cudaGetLastError().
extern "C" int vtd_segmented_cc_round(const void* fg, const void* labels,
                                      void* scratch, void* out, int B, int H,
                                      int W, int diag, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uint8_t* f = static_cast<const uint8_t*>(fg);
  int32_t* a = static_cast<int32_t*>(scratch);
  int32_t* b = static_cast<int32_t*>(out);
  const long long n = (long long)B * H * W;
  min8_kernel<<<blocks_for(n), kThreads, 0, s>>>(
      f, static_cast<const int32_t*>(labels), a, B, H, W);
  run_lines(f, a, B, H, W, 0, s);
  min8_kernel<<<blocks_for(n), kThreads, 0, s>>>(f, a, b, B, H, W);
  run_lines(f, b, B, H, W, 1, s);
  if (diag) {
    run_lines(f, b, B, H, W, 2, s);
    run_lines(f, b, B, H, W, 3, s);
  }
  return static_cast<int>(cudaGetLastError());
}
