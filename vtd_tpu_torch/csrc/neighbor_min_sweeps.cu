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
// whatever `iters` is: 16 x 320 x 320 x 9 B = 14.7 MB, 4.4 us at 3.35 TB/s.
// A design that keeps the labels on chip between sweeps spends the rest of
// its time on instructions: address arithmetic in the load and store, and
// ~6 instructions a cell a sweep. The design counts both.
//
// The TPU kernel holds a whole map in VMEM (a 320x320 int32 map is 400 KB;
// a block here has at most 227 KB of shared memory). Here one block of
// 8 warps owns a 96x96 window of one map: a tile of (96 - 2*halo)^2 output
// cells and a halo of `halo` cells around it. The window's labels live in
// registers for the sweeps, not in shared memory:
//   * load: the window passes through shared memory (labels and a byte
//     mask) so that each global load is a whole row segment of a warp:
//     16-byte label and 4-byte mask loads where W and the window's columns
//     lie on 4-cell groups (the plan's `vec`: W % 4 == 0 and a halo that is
//     a multiple of 4; and 16-byte aligned pointers), else 4-byte and
//     1-byte ones. Every load of a thread is issued before its results are
//     used. Then each thread takes its run: warp w rows [12w, 12w + 12),
//     lane l columns [3l, 3l + 3), 36 cells (background masked to 2^30)
//     and their foreground bits in one 64-bit register. Rows and columns
//     come from threadIdx and blockIdx with compile-time sizes; nothing
//     divides at run time.
//   * the 3x3 minimum is separable: each row's horizontal minimum of three
//     (the neighbours across lanes by warp shuffle, the three-input
//     minimum of Hopper's DPX instructions, one VIMNMX3 each), then the
//     vertical minimum of three row minima as the thread slides down its
//     rows, in place (a row is overwritten only once its own row minimum
//     is taken, so the sweep stays Jacobi).
//   * the rows above and below a warp's run belong to the warps above and
//     below: each sweep every warp writes its first and last row (old
//     values) into shared memory, one barrier, and reads its neighbours'.
//     The rows alternate between two halves by sweep parity, so one
//     barrier a sweep is enough. That is ~0.1 shared accesses per cell per
//     sweep, against ~11 in a design that reads the 3x3 window from shared
//     memory.
//   * store: the foreground results go back into the stage, where the
//     background cells still hold their own labels, and the whole tile
//     goes out in whole rows (16-byte stores with `vec`): every cell of
//     `dst` is written once.
//   * background cells and cells beyond the map edge hold 2^30 in every
//     sweep (they are background, not stale halo), so neighbours need no
//     mask test.
//   * edges of the window: a cell at distance d from the window's border is
//     right after sweep s while d >= s, because what lies beyond the window
//     (here: a lane's own cell at the shuffle's ends, 2^30 above the first
//     and below the last warp) reaches one cell further in per sweep. The
//     centre is at distance halo >= sweeps, and only the centre is stored.
// A launch runs at most `halo` sweeps; the wrapper's launch plan
// (vtd_tpu_torch/ops/cc_kernels.py:sweep_plan) splits larger `iters` into
// several launches of the same kernel between two buffers, which is exact:
// k sweeps and then m sweeps are k + m sweeps. The plan takes halo <= 8, so
// a window carries 96^2 / (96 - 2*halo)^2 <= 1.44x its tile's work, and a
// [16,320,320] map set at iters=8 is 4x4x16 = 256 blocks of 80x80 tiles,
// two an SM (58 KB of shared memory and <= 128 registers a thread each),
// all resident at once. What it leaves on the table: a block loads, then
// sweeps, then stores, so L2 and the integer units are busy in turns; one
// barrier a sweep; the halo's 1.44x.
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

namespace {

constexpr int32_t kBig = 1 << 30;  // sentinel, as in the reference kernel
constexpr unsigned kFull = 0xffffffffu;
constexpr int kLanes = 32;
constexpr int kWarps = 8;
constexpr int kCols = 3;              // consecutive window columns a lane holds
constexpr int kRows = 12;             // consecutive window rows a warp holds
constexpr int kWin = kLanes * kCols;  // window side
constexpr int kPass = kWin / kWarps;  // window rows a warp loads and stores
constexpr int kQuads = kWin / 4;      // 16-byte groups of a window row
static_assert(kWin == kWarps * kRows, "the window is square");
static_assert(kRows * kCols <= 64, "a thread's foreground bits fit 64 bits");
static_assert(kQuads <= kLanes, "a warp loads a window row in one pass");
// Dynamic shared memory: the window's labels (int32) and foreground bytes,
// then each warp's first and last row for two sweep parities.
constexpr int kStageBytes = kWin * kWin * 4;
constexpr int kMaskBytes = kWin * kWin;
constexpr int kEdgeBytes = 2 * kWarps * 2 * kWin * 4;
constexpr int kSmem = kStageBytes + kMaskBytes + kEdgeBytes;

// The launch plan, field for field cc_kernels.py:SweepPlan.
struct Plan {
  int tile;       // output cells a side of a block's tile: kWin - 2*halo
  int halo;       // window cells beyond the tile on each side
  int grid_cols;  // tiles across a map
  int grid_rows;  // tiles down a map
  int launches;   // launch k runs min(halo, iters - k*halo) sweeps
  int smem;       // dynamic shared bytes of a block
  int iters;      // sweeps of all launches together
  int vec;        // W and the window's columns lie on 4-cell groups
};
constexpr int kPlanFields = sizeof(Plan) / sizeof(int);

__device__ __forceinline__ int32_t min3(int32_t a, int32_t b, int32_t c) {
  return __vimin3_s32(a, b, c);  // Hopper's 3-input minimum (DPX)
}

// Horizontal minimum of three over one window row held kCols cells a lane.
// A lane's first cell's left neighbour is the previous lane's last cell,
// its last cell's right neighbour the next lane's first. Lane 0 and lane
// 31 get their own cell back from the shuffle: those cells are the
// window's border, whose results never reach the centre.
__device__ __forceinline__ void row_min(const int32_t (&x)[kCols],
                                        int32_t (&h)[kCols]) {
  const int32_t left = __shfl_up_sync(kFull, x[kCols - 1], 1);
  const int32_t right = __shfl_down_sync(kFull, x[0], 1);
#pragma unroll
  for (int j = 0; j < kCols; ++j)
    h[j] = min3(j == 0 ? left : x[j > 0 ? j - 1 : 0], x[j],
                j == kCols - 1 ? right : x[j < kCols - 1 ? j + 1 : j]);
}

// kVec: 16-byte label and 4-byte mask accesses, lane l < kQuads taking
// window columns [4l, 4l + 4) of a row; a group lies wholly in or out of
// the map and of the tile (the plan's `vec`). Else 4-byte and 1-byte
// accesses, lane l taking columns l, l + 32, l + 64.
template <bool kVec>
__global__ void __launch_bounds__(kLanes * kWarps, 2)
    sweeps_kernel(const uint8_t* __restrict__ fg,
                  const int32_t* __restrict__ src, int32_t* __restrict__ dst,
                  int H, int W, int tile, int halo, int sweeps) {
  extern __shared__ __align__(16) unsigned char smem[];
  // labels as loaded (2^30 beyond the map), later the results
  auto stage = reinterpret_cast<int32_t(*)[kWin]>(smem);
  auto mask = reinterpret_cast<uint8_t(*)[kWin]>(smem + kStageBytes);
  auto edge = reinterpret_cast<int32_t(*)[kWarps][2][kWin]>(
      smem + kStageBytes + kMaskBytes);
  const int lane = threadIdx.x, warp = threadIdx.y;
  const int top = blockIdx.y * tile - halo;  // map cell of window cell (0,0)
  const int left = blockIdx.x * tile - halo;
  const size_t plane = (size_t)H * W;
  fg += blockIdx.z * plane;
  src += blockIdx.z * plane;
  dst += blockIdx.z * plane;
  auto in_tile = [&](int w) { return (unsigned)(w - halo) < (unsigned)tile; };
  auto at = [&](int r, int c) { return (long long)r * W + c; };

  // 1. Load the window in whole rows: warp w takes rows w, w + kWarps, ...;
  // every load of a thread is issued before its results are used.
  if (kVec) {
    if (lane < kQuads) {
      const int c = left + 4 * lane;
      const bool col_in = (unsigned)c < (unsigned)W;
      int4 x[kPass];
      uint32_t f[kPass];
#pragma unroll
      for (int k = 0; k < kPass; ++k) {
        const int r = top + warp + k * kWarps;
        const bool in = col_in && (unsigned)r < (unsigned)H;
        x[k] = in ? __ldg(reinterpret_cast<const int4*>(src + at(r, c)))
                  : make_int4(kBig, kBig, kBig, kBig);
        f[k] = in ? __ldg(reinterpret_cast<const uint32_t*>(fg + at(r, c)))
                  : 0u;
      }
#pragma unroll
      for (int k = 0; k < kPass; ++k) {
        const int wr = warp + k * kWarps;
        *reinterpret_cast<int4*>(&stage[wr][4 * lane]) = x[k];
        *reinterpret_cast<uint32_t*>(&mask[wr][4 * lane]) = f[k];
      }
    }
  } else {
    constexpr int kChunk = 4;  // rows of loads in flight
    static_assert(kPass % kChunk == 0, "whole chunks");
#pragma unroll
    for (int k0 = 0; k0 < kPass; k0 += kChunk) {
      int32_t x[kChunk][kCols];
      uint32_t f[kChunk][kCols];
#pragma unroll
      for (int k = 0; k < kChunk; ++k) {
        const int r = top + warp + (k0 + k) * kWarps;
#pragma unroll
        for (int j = 0; j < kCols; ++j) {
          const int c = left + lane + j * kLanes;
          const bool in = (unsigned)r < (unsigned)H && (unsigned)c < (unsigned)W;
          x[k][j] = in ? __ldg(src + at(r, c)) : kBig;
          f[k][j] = in ? __ldg(fg + at(r, c)) : 0u;
        }
      }
#pragma unroll
      for (int k = 0; k < kChunk; ++k)
#pragma unroll
        for (int j = 0; j < kCols; ++j) {
          const int wr = warp + (k0 + k) * kWarps, wc = lane + j * kLanes;
          stage[wr][wc] = x[k][j];
          mask[wr][wc] = f[k][j];
        }
    }
  }
  __syncthreads();

  // 2. The thread's run into registers, background masked to 2^30: warp w
  // rows [w*kRows, +kRows), lane l columns [l*kCols, +kCols) (a stride of
  // kCols words across the lanes: no bank conflicts).
  const int wr = warp * kRows, wc = lane * kCols;
  int32_t v[kRows][kCols];
  uint64_t on = 0;  // bit i*kCols + j: v[i][j] is a foreground cell
#pragma unroll
  for (int i = 0; i < kRows; ++i)
#pragma unroll
    for (int j = 0; j < kCols; ++j) {
      const bool f = mask[wr + i][wc + j] != 0;
      v[i][j] = f ? stage[wr + i][wc + j] : kBig;
      on |= (uint64_t)f << (i * kCols + j);
    }

  // 3. The sweeps.
  for (int s = 0; s < sweeps; ++s) {
    int32_t(*e)[2][kWin] = edge[s & 1];
#pragma unroll
    for (int j = 0; j < kCols; ++j) {
      e[warp][0][wc + j] = v[0][j];
      e[warp][1][wc + j] = v[kRows - 1][j];
    }
    __syncthreads();
    int32_t up[kCols], down[kCols];
#pragma unroll
    for (int j = 0; j < kCols; ++j) {
      up[j] = warp > 0 ? e[warp - 1][1][wc + j] : kBig;
      down[j] = warp < kWarps - 1 ? e[warp + 1][0][wc + j] : kBig;
    }
    // row minima of the row above (a), the current row (b), below (c)
    int32_t a[kCols], b[kCols], c[kCols];
    row_min(up, a);
    row_min(v[0], b);
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      if (i + 1 < kRows)
        row_min(v[i + 1 < kRows ? i + 1 : i], c);
      else
        row_min(down, c);
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const int32_t m = min3(a[j], b[j], c[j]);
        v[i][j] = (on >> (i * kCols + j)) & 1 ? m : kBig;
        a[j] = b[j];
        b[j] = c[j];
      }
    }
  }

  // 4. Foreground results into the stage (every thread has passed a
  // barrier since step 2 read it); background cells keep their labels
  // there. Then the tile goes out in whole rows.
#pragma unroll
  for (int i = 0; i < kRows; ++i)
#pragma unroll
    for (int j = 0; j < kCols; ++j)
      if ((on >> (i * kCols + j)) & 1) stage[wr + i][wc + j] = v[i][j];
  __syncthreads();
  if (kVec) {
    const int c = left + 4 * lane;
    if (lane < kQuads && in_tile(4 * lane) && c < W) {
#pragma unroll
      for (int k = 0; k < kPass; ++k) {
        const int rr = warp + k * kWarps, r = top + rr;
        if (in_tile(rr) && r < H)
          *reinterpret_cast<int4*>(dst + at(r, c)) =
              *reinterpret_cast<const int4*>(&stage[rr][4 * lane]);
      }
    }
  } else {
#pragma unroll
    for (int k = 0; k < kPass; ++k) {
      const int rr = warp + k * kWarps, r = top + rr;
      if (!in_tile(rr) || r >= H) continue;
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const int cc = lane + j * kLanes, c = left + cc;
        if (in_tile(cc) && c < W) dst[at(r, c)] = stage[rr][cc];
      }
    }
  }
}

// Opt each kernel in to kSmem bytes of dynamic shared memory, once per
// device.
cudaError_t opt_in() {
  static std::atomic<unsigned long long> done{0};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  const unsigned long long bit = 1ull << (dev & 63);
  if (done.load() & bit) return cudaSuccess;
  if ((e = cudaFuncSetAttribute(sweeps_kernel<true>,
                                cudaFuncAttributeMaxDynamicSharedMemorySize,
                                kSmem)) != cudaSuccess ||
      (e = cudaFuncSetAttribute(sweeps_kernel<false>,
                                cudaFuncAttributeMaxDynamicSharedMemorySize,
                                kSmem)) != cudaSuccess)
    return e;
  done.fetch_or(bit);
  return cudaSuccess;
}

bool aligned(const void* p, uintptr_t n) {
  return (reinterpret_cast<uintptr_t>(p) & (n - 1)) == 0;
}

}  // namespace

// fg [B,H,W] uint8 (0/1), labels [B,H,W] int32 (read only), out [B,H,W]
// int32 (written), spare [B,H,W] int32 (scratch, needed when the plan has
// more than one launch, else may be null). `plan` holds the Plan fields
// (kPlanFields ints). Runs plan.launches launches on `stream`, between
// `spare` and `out` so that the last one writes `out`, each with 16-byte
// accesses where the plan's `vec` and its pointers allow; does not
// synchronise; returns a CUDA error code (cudaErrorInvalidValue for a plan
// that does not fit the kernel or does not cover the maps).
extern "C" int vtd_neighbor_min_sweeps(const void* fg, const void* labels,
                                       void* out, void* spare, int B, int H,
                                       int W, const int* plan, void* stream) {
  Plan p;
  static_assert(kPlanFields == 8, "Plan fields");
  int* fields = reinterpret_cast<int*>(&p);
  for (int i = 0; i < kPlanFields; ++i) fields[i] = plan[i];
  const long long tile = p.tile, halo = p.halo;
  if (B < 1 || H < 1 || W < 1 || halo < 1 || tile != kWin - 2 * halo ||
      tile < 1 || p.smem != kSmem || p.grid_cols * tile < W ||
      (p.grid_cols - 1) * tile >= W || p.grid_rows * tile < H ||
      (p.grid_rows - 1) * tile >= H || p.launches < 1 ||
      p.launches * halo < p.iters || (p.launches - 1) * halo >= p.iters ||
      (p.launches > 1 && spare == nullptr) ||
      (p.vec && (W % 4 != 0 || halo % 4 != 0)))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t e = opt_in();
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid(p.grid_cols, p.grid_rows, B), block(kLanes, kWarps);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uint8_t* f = static_cast<const uint8_t*>(fg);
  const int32_t* from = static_cast<const int32_t*>(labels);
  for (int k = 0; k < p.launches; ++k) {
    int32_t* to = static_cast<int32_t*>(((p.launches - 1 - k) & 1) ? spare
                                                                     : out);
    const int sweeps = min(p.halo, p.iters - k * p.halo);
    if (p.vec && aligned(f, 4) && aligned(from, 16) && aligned(to, 16))
      sweeps_kernel<true><<<grid, block, kSmem, s>>>(f, from, to, H, W,
                                                     p.tile, p.halo, sweeps);
    else
      sweeps_kernel<false><<<grid, block, kSmem, s>>>(f, from, to, H, W,
                                                      p.tile, p.halo, sweeps);
    from = to;
  }
  return static_cast<int>(cudaGetLastError());
}
