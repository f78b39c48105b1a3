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
// 400 KB, more than the 227 KB of shared memory a block can have. Here a
// round is 2 kernels (4 with diag), each one pass over strips of the map
// held in shared memory: the map crosses L2 once per kernel, and every
// step of a scan or a stencil is a shared-memory access.
//   K1 strip_kernel: one block per strip of R whole rows (plus a halo row
//      above and below) of one map, loaded with 16-byte loads. min8 from
//      the loaded labels (Jacobi: a window over the loaded buffer, the
//      result in another; an in-place stencil would carry a label further
//      than the reference), fused into the row run-min, one warp per row.
//      The strip is written transposed, labels and mask, into `scratch`.
//   K2 strip_kernel again, on the transposed map: its rows are the map's
//      columns, so it is min8 then the column run-min with the same
//      contiguous loads, and its transposed result is `out`. Halo lines
//      belong to other blocks, so neither kernel runs in place.
//   K3/K4 diag_kernel: main (then anti) diagonals, in place on `out`, in
//      runs of D/2 consecutive diagonals; a block takes a run of short and
//      a run of long diagonals, so blocks carry about the same number of
//      cells. A run's parallelogram is loaded row by row (D/2 contiguous
//      cells a row) and stored sheared, cell (r, c) at (r, c - r - k0)
//      (anti: (r, c + r - k0)), so a diagonal is a column of the strip.
//      Each cell lies on one diagonal of each kind, so blocks never
//      overlap; K4 runs after K3 because the anti pass starts from the
//      main pass.
// A run minimum is one warp per line: each lane runs a sequential scan
// over its n/32 consecutive cells in shared memory, forward and back, and
// one segmented shuffle scan of the lanes' summaries joins runs that cross
// lanes (line_runmin). Global loads are staged, all of a thread's cells in
// flight at once. Registers are kept to <= 48 a thread, so the 640 blocks
// of a [16,320,320] phase (5 an SM) run in one wave.
//
// The launch plan (R, C, D, grids, dynamic shared bytes) comes from the
// wrapper (vtd_tpu_torch/ops/cc_kernels.py:segmented_plan), which refuses
// maps whose strips do not fit a block's shared memory. What the design
// leaves on the table: every block of a phase loads at once, then scans,
// then stores, so L2 is busy in bursts; one L2 round trip per kernel and
// the launch gaps between the 2-4 kernels of a round (a thread-block
// cluster holding a map in distributed shared memory could run a round
// as one launch).
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int32_t kBig = 1 << 30;  // sentinel, as in the reference
constexpr unsigned kFull = 0xffffffffu;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kStaticSmem = 48 * 1024;  // above this, opt in per kernel
constexpr int32_t kNone = 0x7fffffff;  // identity of min in the scans
// Loads a thread keeps in flight: at [16,320,320] one stage holds a row
// strip (800 quads) or a diagonal block's two runs (~2560 cells), and
// registers stay <= 48 a thread, 5 blocks an SM.
constexpr int kStageRows = 4, kStageDiag = 10;

// The launch plan, field for field cc_kernels.py:SegmentedPlan.
struct Plan {
  int rows, cols, diags;                  // R, C, D
  int grid_rows, grid_cols, grid_diag;    // blocks per map of each phase
  int smem_rows, smem_cols, smem_diag;    // dynamic shared bytes
  int main_first, anti_first;             // first diagonal of each kind
};
constexpr int kPlanFields = sizeof(Plan) / sizeof(int);

// Shared-memory layout, mirrored by cc_kernels.py (_strip_smem, _diag_smem).
__host__ __device__ __forceinline__ int odd(int n) { return n | 1; }
__host__ __device__ __forceinline__ int mask_pitch(int n) {
  return odd((n + 3) / 4) * 4;  // bytes; an odd number of words
}
// A strip of R lines of n cells: masked and working labels of the R lines
// and the two halo lines, and their mask, each with 3 cells of slack for
// the 16-byte phase.
__host__ __device__ __forceinline__ int strip_words(int R, int n) {
  return ((R + 2) * n + 3 + 3) / 4 * 4;
}
int strip_smem(int R, int n) {
  return 8 * strip_words(R, n) + ((R + 2) * n + 3 + 15) / 16 * 16;
}
int diag_smem(int D, int H) {  // two runs of D/2 diagonals, H rows each
  return 2 * H * (4 * odd(D / 2) + mask_pitch(D / 2));
}

// The value a foreground cell enters the run-min with, for cells a, a+1,
// ... of a lane in order: the line's own labels ...
struct OwnLabels {
  const int32_t* v;
  int vs;
  __device__ void start(int) {}
  __device__ int32_t at(int i) const { return v[i * vs]; }
};

// ... or min8, the minimum of the masked labels (kBig on the background
// and beyond the edge) over the cell's 3x3 window, as a window sliding
// along the line. x, y, z are the line and its two neighbours in the
// masked buffer (a neighbour beyond the map edge is replaced by the line
// itself, which changes no minimum); across(i) is the minimum of the three
// at position i. Jacobi: the window reads the masked buffer, the scan
// writes another one.
struct Min8Window {
  const int32_t *x, *y, *z;
  int step, n;
  int32_t prev, cur;
  __device__ int32_t across(int i) const {
    if (i < 0 || i >= n) return kBig;
    const int o = i * step;
    return min(min(x[o], y[o]), z[o]);
  }
  __device__ void start(int a) {
    prev = across(a - 1);
    cur = across(a);
  }
  __device__ int32_t at(int i) {
    const int32_t next = across(i + 1);
    const int32_t m = min(min(prev, cur), next);
    prev = cur;
    cur = next;
    return m;
  }
};

// Run minimum of the foreground along one line of n cells in shared
// memory, in place: cell i at v[i * vs], its mask at m[i * ms]; a
// foreground cell enters with seed.at(i). One warp; lane l owns the L
// consecutive cells [l*L, l*L + L), L = ceil(n / 32) made odd so that the
// lanes' strided accesses hit 32 banks:
//   1. forward over its cells: prefix minimum within each run, in place;
//      the lane's summary is the minimum of its leading run (`lead`), the
//      prefix at its last cell (`tail`) and whether every cell is
//      foreground (`full`);
//   2. two segmented scans of the summaries across the warp (5 shuffle
//      steps each) give the minimum of the run entering from the left
//      (`cin`) and from the right (`din`);
//   3. back over its cells: suffix minimum of the prefixes within each run,
//      seeded with `din`, and `cin` for the leading run = the run minimum.
// Background cells are not written. kNone (the int32 maximum) is the
// scans' identity, so no label is capped.
template <class Seed>
__device__ void line_runmin(int32_t* v, int vs, const uint8_t* m, int ms,
                            int n, int lane, Seed seed) {
  const int L = ((n + 31) >> 5) | 1;
  const int a = min(lane * L, n), e = min(a + L, n);
  int32_t p = kNone, lead = kNone;
  int first_bg = e;  // my first background cell
  seed.start(a);
  for (int i = a; i < e; ++i) {
    const int32_t x = seed.at(i);
    if (m[i * ms]) {
      p = min(p, x);
      v[i * vs] = p;
    } else {
      if (first_bg == e) { first_bg = i; lead = p; }
      p = kNone;
    }
  }
  const bool full = first_bg == e;  // also for a lane with no cells
  if (full) lead = p;
  int32_t c = p, d = lead;  // inclusive scans of (tail, full), (lead, full)
  bool cf = full, df = full;
  for (int k = 1; k < 32; k <<= 1) {
    const int32_t oc = __shfl_up_sync(kFull, c, k);
    const bool ocf = __shfl_up_sync(kFull, cf, k);
    const int32_t od = __shfl_down_sync(kFull, d, k);
    const bool odf = __shfl_down_sync(kFull, df, k);
    if (lane >= k) {
      if (cf) c = min(c, oc);
      cf = cf && ocf;
    }
    if (lane + k < 32) {
      if (df) d = min(d, od);
      df = df && odf;
    }
  }
  int32_t cin = __shfl_up_sync(kFull, c, 1);
  int32_t s = __shfl_down_sync(kFull, d, 1);  // din, then the suffix
  if (lane == 0) cin = kNone;
  if (lane == 31) s = kNone;
  for (int i = e - 1; i >= a; --i) {
    const int32_t x = v[i * vs];
    if (m[i * ms]) {
      s = min(s, x);
      v[i * vs] = i < first_bg ? min(s, cin) : s;
    } else {
      s = kNone;
    }
  }
}

// Calls f(r, j) for every cell r < nr, j < nj <= kThreads of a strip:
// thread t takes column t % nj and every step-th row from t / nj, with
// step = kThreads / nj (the last kThreads % nj threads idle), so
// consecutive threads touch consecutive cells of a row.
template <class F>
__device__ __forceinline__ void for_cells(int nr, int nj, F f) {
  const int step = kThreads / nj;
  if (threadIdx.x >= step * nj) return;
  const int j = threadIdx.x % nj;
  for (int r = threadIdx.x / nj; r < nr; r += step) f(r, j);
}

// Loads every cell (r, j), r < nr, j < nj <= kThreads, of a strip with
// `load(r, j)` and hands it to `store(r, j, x)`. Thread t takes column
// t % nj and rows t / nj + u * step (step = kThreads / nj rows a sweep;
// the last kThreads % nj threads idle), S rows at a time: all of a stage's
// global loads are in flight before the first shared store, and the stage
// holds nothing but the loaded values.
template <int S, class Load, class Store>
__device__ __forceinline__ void staged(int nr, int nj, Load load,
                                       Store store) {
  const int step = kThreads / nj;
  if (threadIdx.x >= step * nj) return;
  const int j = threadIdx.x % nj;
  for (int r0 = threadIdx.x / nj; r0 < nr; r0 += S * step) {
    decltype(load(0, 0)) x[S];
#pragma unroll
    for (int u = 0; u < S; ++u)
      if (r0 + u * step < nr) x[u] = load(r0 + u * step, j);
#pragma unroll
    for (int u = 0; u < S; ++u)
      if (r0 + u * step < nr) store(r0 + u * step, j, x[u]);
  }
}

struct Cell {  // one cell: label and mask
  int32_t v;
  uint8_t f;
};

struct Quad {  // four consecutive cells
  int4 v;
  uint32_t f;
};

// K1 and K2: min8 then row run-min over a strip of R rows of a [H, W] map
// (labels `src`, mask `fg`), written transposed: the result goes to `dst`
// as a [W, H] map and, when `dst_mask` is given, the mask as a [W, H] map
// of bytes. K1 runs it on the round's input into `scratch`; K2 runs it on
// that transposed map, so its row run-min is the column run-min, and its
// transposed result is `out` in the input's layout. Both read whole rows
// with 16-byte loads.
__global__ void __launch_bounds__(kThreads)
strip_kernel(const uint8_t* __restrict__ fg, const int32_t* __restrict__ src,
             int32_t* __restrict__ dst, uint8_t* __restrict__ dst_mask,
             int H, int W, int R) {
  extern __shared__ __align__(16) unsigned char smem[];
  const size_t base = (size_t)blockIdx.y * H * W;
  const int r0 = blockIdx.x * R;
  const int rows = min(R, H - r0);
  const int lo = max(r0 - 1, 0);           // first loaded row
  const int hi = min(r0 + rows + 1, H);    // one past the last
  const int n = (hi - lo) * W;
  const int32_t* lp = src + base + (size_t)lo * W;
  const uint8_t* mp = fg + base + (size_t)lo * W;
  // Strip cell k sits at index k of each buffer, shifted by the labels'
  // 16-byte phase so that global and shared vectors line up.
  const int ph = (int)(((uintptr_t)lp >> 2) & 3);
  const int words = strip_words(R, W);
  int32_t* masked = reinterpret_cast<int32_t*>(smem) + ph;  // bg: kBig
  int32_t* out = reinterpret_cast<int32_t*>(smem) + words + ph;
  uint8_t* on = smem + 8 * words + ph;

  auto put = [&](int k, int32_t v, uint8_t f) {
    masked[k] = f ? v : kBig;
    out[k] = v;
    on[k] = f;
  };
  // the mask's 4-byte phase matches when both tensors start alike
  const bool vec = ((uintptr_t)mp & 3) == (uintptr_t)ph;
  const int head = vec ? min((4 - ph) & 3, n) : n;
  for (int k = threadIdx.x; k < head; k += kThreads) put(k, lp[k], mp[k]);
  if (vec) {
    const int nv = (n - head) >> 2;
    const int4* lv = reinterpret_cast<const int4*>(lp + head);
    const uint32_t* mv = reinterpret_cast<const uint32_t*>(mp + head);
    staged<kStageRows>(
        nv, 1, [&](int q, int) { return Quad{lv[q], mv[q]}; },
        [&](int q, int, Quad x) {
          const int k = head + 4 * q;
          int4 mk;
          mk.x = (x.f & 0xffu) ? x.v.x : kBig;
          mk.y = (x.f & 0xff00u) ? x.v.y : kBig;
          mk.z = (x.f & 0xff0000u) ? x.v.z : kBig;
          mk.w = (x.f & 0xff000000u) ? x.v.w : kBig;
          *reinterpret_cast<int4*>(masked + k) = mk;
          *reinterpret_cast<int4*>(out + k) = x.v;
          *reinterpret_cast<uint32_t*>(on + k) = x.f;
        });
    for (int k = head + 4 * nv + threadIdx.x; k < n; k += kThreads)
      put(k, lp[k], mp[k]);
  }
  __syncthreads();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int i = warp; i < rows; i += kWarps) {
    const int r = r0 + i;
    const int k0 = (r - lo) * W;
    const int32_t* mid = masked + k0;
    const Min8Window win{r > lo ? mid - W : mid, mid,
                         r + 1 < hi ? mid + W : mid, 1, W};
    line_runmin(out + k0, 1, on + k0, 1, W, lane, win);
  }
  __syncthreads();

  // The strip's column c is `rows` consecutive cells of the transposed
  // map. Where they lie on 16-byte vectors (rows of 4 or 8, H a multiple
  // of 4), a thread writes 4 of them, so a warp writes whole 32-byte
  // sectors; otherwise a thread writes a column cell by cell.
  const int32_t* sv = out + (r0 - lo) * W;  // strip cell (j, c) at j*W + c
  const uint8_t* sm = on + (r0 - lo) * W;
  if ((rows == 4 || rows == 8) && r0 % 4 == 0 && H % 4 == 0) {
    const int sh = rows == 8;  // log2 of the threads a column
    for (int i = threadIdx.x; i < W << sh; i += kThreads) {
      const int c = i >> sh, j = (i & sh) * 4, k = j * W + c;
      const size_t g = base + (size_t)c * H + r0 + j;
      *reinterpret_cast<int4*>(dst + g) =
          make_int4(sv[k], sv[k + W], sv[k + 2 * W], sv[k + 3 * W]);
      if (dst_mask)
        *reinterpret_cast<uint32_t*>(dst_mask + g) =
            sm[k] | sm[k + W] << 8 | sm[k + 2 * W] << 16 |
            (uint32_t)sm[k + 3 * W] << 24;
    }
  } else {
    for (int c = threadIdx.x; c < W; c += kThreads) {
      const size_t g = base + (size_t)c * H + r0;
      for (int j = 0; j < rows; ++j) {
        dst[g + j] = sv[j * W + c];
        if (dst_mask) dst_mask[g + j] = sm[j * W + c];
      }
    }
  }
}

// K3 (sign +1, main diagonals c - r = k) and K4 (sign -1, anti-diagonals
// c + r = k): run minimum along every diagonal, in place. The H + W - 1
// diagonals of a kind form runs of Dh = D/2 consecutive ones, run g
// starting at first + g*Dh. Block b takes runs b and b + gridDim.x: a run
// of short diagonals is paired with one of long diagonals, so that blocks
// carry about the same number of cells. A run's strip holds the rows that
// meet its diagonals; strip cell (i, j) of run u is map cell
// (u.rlo + i, sign * (u.rlo + i) + u.k0 + j), so a diagonal is a column of
// the strip. The second run's rows follow the first's in shared memory.
struct Run {
  int k0, rlo, rows;
};

__device__ Run run_of(int g, int Dh, int H, int W, int sign, int first) {
  Run u{first + g * Dh, 0, 0};
  if (g * Dh < H + W - 1) {
    const int lo = max(0, sign > 0 ? -(u.k0 + Dh - 1) : u.k0 - W + 1);
    const int hi = min(H, sign > 0 ? W - u.k0 : u.k0 + Dh);
    u.rlo = lo;
    u.rows = max(hi - lo, 0);
  }
  return u;
}

__global__ void __launch_bounds__(kThreads)
diag_kernel(const uint8_t* __restrict__ fg, int32_t* __restrict__ lbl,
            int H, int W, Plan p, int sign, int first) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int Dh = p.diags / 2, pv = odd(Dh), pm = mask_pitch(Dh);
  int32_t* val = reinterpret_cast<int32_t*>(smem);
  uint8_t* on = reinterpret_cast<uint8_t*>(val + 2 * H * pv);
  const size_t base = (size_t)blockIdx.y * H * W;
  const Run ra = run_of(blockIdx.x, Dh, H, W, sign, first);
  const Run rb = run_of(blockIdx.x + gridDim.x, Dh, H, W, sign, first);
  const int nr = ra.rows + rb.rows;
  if (nr == 0) return;  // the whole block leaves, before any barrier
  // strip row v: row v of run a, or row v - ra.rows of run b
  auto map_cell = [&](int v, int j, int& r, int& c) {
    const bool a = v < ra.rows;
    r = a ? ra.rlo + v : rb.rlo + v - ra.rows;
    c = sign * r + (a ? ra.k0 : rb.k0) + j;
  };

  staged<kStageDiag>(
      nr, Dh,
      [&](int v, int j) {
        int r, c;
        map_cell(v, j, r, c);
        Cell x{kBig, 0};  // beyond the map edge: background
        if (c >= 0 && c < W) {
          const size_t g = base + (size_t)r * W + c;
          x.v = lbl[g];
          x.f = fg[g];
        }
        return x;
      },
      [&](int v, int j, Cell x) {
        val[v * pv + j] = x.v;
        on[v * pm + j] = x.f;
      });
  __syncthreads();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int t = warp; t < 2 * Dh; t += kWarps) {
    const bool a = t < Dh;
    const Run& u = a ? ra : rb;
    const int j = a ? t : t - Dh, v0 = a ? 0 : ra.rows;
    const int k = u.k0 + j;  // this column's diagonal: rows where 0 <= c < W
    const int rs = max(u.rlo, sign > 0 ? -k : k - W + 1);
    const int re = min(u.rlo + u.rows, sign > 0 ? W - k : k + 1);
    if (re > rs) {
      const int v = v0 + rs - u.rlo;
      line_runmin(val + v * pv + j, pv, on + v * pm + j, pm, re - rs, lane,
                  OwnLabels{val + v * pv + j, pv});
    }
  }
  __syncthreads();

  for_cells(nr, Dh, [&](int v, int j) {
    if (!on[v * pm + j]) return;
    int r, c;
    map_cell(v, j, r, c);
    lbl[base + (size_t)r * W + c] = val[v * pv + j];
  });
}

cudaError_t opt_in(const void* kernel, int bytes) {
  if (bytes <= kStaticSmem) return cudaSuccess;
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

}  // namespace

// fg [B,H,W] uint8 (0/1), labels [B,H,W] int32 (read only), scratch
// (B*H*W rounded up to 4, plus B*H*W/4 rounded up, int32 words) and out
// [B,H,W] int32 (written); the result lands in out.
// `plan` holds the Plan fields (kPlanFields ints). Launches 2 kernels (4
// with diag) on `stream`, does not synchronise, returns a CUDA error code
// (cudaErrorInvalidValue for a plan whose shared bytes do not hold its
// strips).
extern "C" int vtd_segmented_cc_round(const void* fg, const void* labels,
                                      void* scratch, void* out, int B, int H,
                                      int W, int diag, const int* plan,
                                      void* stream) {
  Plan p;
  static_assert(kPlanFields == 11, "Plan fields");
  int* dst = reinterpret_cast<int*>(&p);
  for (int i = 0; i < kPlanFields; ++i) dst[i] = plan[i];
  if (B < 1 || H < 1 || W < 1 || p.rows < 1 || p.cols < 1 || p.diags < 2 ||
      strip_smem(p.rows, W) > p.smem_rows ||
      strip_smem(p.cols, H) > p.smem_cols ||
      diag_smem(p.diags, H) > p.smem_diag)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uint8_t* f = static_cast<const uint8_t*>(fg);
  // scratch: the transposed labels, then from the next 16-byte boundary
  // the transposed mask
  int32_t* a = static_cast<int32_t*>(scratch);
  uint8_t* am = reinterpret_cast<uint8_t*>(
      a + (((size_t)B * H * W + 3) & ~(size_t)3));
  int32_t* b = static_cast<int32_t*>(out);
  cudaError_t e;
  if ((e = opt_in((const void*)strip_kernel,
                  p.smem_rows > p.smem_cols ? p.smem_rows : p.smem_cols)) !=
          cudaSuccess ||
      (diag &&
       (e = opt_in((const void*)diag_kernel, p.smem_diag)) != cudaSuccess))
    return static_cast<int>(e);
  strip_kernel<<<dim3(p.grid_rows, B), kThreads, p.smem_rows, s>>>(
      f, static_cast<const int32_t*>(labels), a, am, H, W, p.rows);
  strip_kernel<<<dim3(p.grid_cols, B), kThreads, p.smem_cols, s>>>(
      am, a, b, nullptr, W, H, p.cols);
  if (diag) {
    diag_kernel<<<dim3(p.grid_diag, B), kThreads, p.smem_diag, s>>>(
        f, b, H, W, p, 1, p.main_first);
    diag_kernel<<<dim3(p.grid_diag, B), kThreads, p.smem_diag, s>>>(
        f, b, H, W, p, -1, p.anti_first);
  }
  return static_cast<int>(cudaGetLastError());
}
