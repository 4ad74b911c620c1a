// Raster min-label connected components for Hopper (sm_90a).
//
// Replaces the TPU kernel vanishing_points_2017_tpu/ops/ccl_pallas.py
// (_half_pass_kernel, launched by connected_components_pallas_batch). Same
// pass semantics as the plain twin
// ops/lines_device.py::connected_components_ref: labels start as flat pixel
// indices; each half pass walks the rows in order (descending rows first,
// then ascending), injects the previous row's final labels through the
// N/NW/NE edge bits (S/SW/SE when ascending), then spreads them within the
// row by a forward and a backward segmented min scan over the W/E edge
// bits. `passes` half passes alternate descending/ascending. Eight passes
// do not always reach the CCL fixpoint, so a union-find CCL would give
// other labels exactly where they fall short: this kernel reproduces the
// passes, not the fixpoint. Input is the packed 8-direction edge bit-plane
// computed once in PyTorch (ops/lines_device.py::pack_edge_masks), so the
// kernel works on integers only; a segmented min is the same whichever
// scan computes it, so the labels are bit-exact against the twin.
//
// What bounds it: rows are a sequential dependency, so an image's half
// pass is H dependent row steps (8 x 639 = 5112 at the main path's grid),
// and the critical path is the length of one row step, not bandwidth (the
// bytes that must move, 2 x 4 B per pixel, take ~0.03 ms at b32). A row
// step is a few hundred integer instructions per warp, which an SM
// sub-partition issues at half a warp-instruction per cycle, plus shuffle
// and barrier latencies: its instruction count is what bounds the kernel.
// What the design does about it: one block of kWarps = 4 warps per image,
// one warp per sub-partition, one image per SM (one warp per image left
// three sub-partitions idle). Lane i of warp w holds C = ceil(W / 128)
// contiguous columns in registers (C is a template parameter, so the
// arrays stay in registers): the forward and backward segmented scans run
// sequentially over a lane's own columns, then a 5-round shuffle scan of
// the lane carries inside the warp, then each warp folds the other warps'
// summaries, then an independent fix-up per column. No barrier sits inside
// a scan: a row step has two, one that publishes the warp summaries and one
// that publishes the warps' edge columns (the next row's NW/NE at warp
// edges; inside a warp they come from shuffles). The previous row stays in
// registers. The pass kind is a template parameter, so the mask bits are
// constants, and every conditional min is a select then a min. Each half
// pass is its own launch, so the previous pass's labels are read-only for
// it: each lane loads its own columns of the mask and of those labels two
// rows ahead into registers through the read-only path (rows do not
// depend on each other's loads; a 4-byte cp.async ring in shared memory
// cost more issue slots than it saved). Output rows are staged in shared
// memory at an odd pitch per lane (a lane's contiguous columns hit
// distinct banks) and written coalesced.
//
// Grids wider than 1024 columns (8 columns per lane would spill past 8)
// take a second kernel, ccl_half_pass_wide: the same block of 4 warps
// walks a row in groups of 1024 columns, 8 per lane. A row step makes a
// forward sweep over the groups (left to right: inject, forward lane and
// warp scans, the carry of the groups to the left folded in; the forward
// minima are stored in the output row) and a backward sweep (right to
// left: the injection recomputed, backward scans, the carry of the groups
// to the right, the final min with the stored forward value). The carry
// between groups is a register every thread folds alike, so any width
// runs with the same shared memory. The previous row is read back from
// the output after a barrier, not kept in registers. Each group costs a
// barrier and a load round trip, so the wide kernel is slower per column
// than the narrow one; the main path's 639 columns never take it.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMax = 0x7fffffff;
constexpr int kWarps = 4;
constexpr int kMaxCols = 8;  // columns per lane of the narrow kernel
constexpr int kMaxWidth = 32 * kWarps * kMaxCols;
constexpr unsigned kFull = 0xffffffffu;

// the kind of a half pass: the first (descending, labels are the flat
// indices), a later descending one, an ascending one
enum Pass { kFirstPass, kDescending, kAscending };

// bit index per neighbour direction (dy, dx), as in the JAX package:
// (-1,-1) 0, (-1,0) 1, (-1,1) 2, (0,-1) 3, (0,1) 4, (1,-1) 5, (1,0) 6, (1,1) 7
constexpr int kW = 1 << 3, kE = 1 << 4;

// half pass `MODE` over one image per block: reads the labels of the
// previous half pass from `in` (none for the first), writes its own to `out`
template <int C, int MODE>
__global__ void __launch_bounds__(32 * kWarps)
    ccl_half_pass(const int32_t* __restrict__ packed,
                  const int32_t* __restrict__ in,
                  int32_t* __restrict__ out, int H, int W) {
  constexpr bool kFirst = MODE == kFirstPass, kAsc = MODE == kAscending;
  // the bits that inject the previous row: N/NW/NE, or S/SW/SE ascending
  constexpr int kUpl = kAsc ? 1 << 5 : 1 << 0;
  constexpr int kUp = kAsc ? 1 << 6 : 1 << 1;
  constexpr int kUpr = kAsc ? 1 << 7 : 1 << 2;
  constexpr int P = C | 1;  // odd pitch per lane: conflict-free lane access
  constexpr int SPAN = 32 * C;  // columns per warp
  constexpr uint32_t kAll = (1u << C) - 1;
  __shared__ int32_t s_out[2][kWarps][32 * P];  // by row parity
  __shared__ int32_t s_sum[kWarps][4];   // fwd min, fwd joins, bwd min, ...
  __shared__ int32_t s_edge[kWarps][2];  // a warp's first and last column

  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int x0 = w * SPAN + lane * C;  // this lane's first column
  const size_t img = (size_t)blockIdx.x * H * W;
  const int32_t* pk = packed + img + x0;
  const int32_t* lin = in + img + x0;
  // coalesced output: this lane writes columns w * SPAN + lane + 32 j,
  // staged by lane (lane + 32 j) / C
  int32_t* lab = out + img + w * SPAN + lane;
  int slot[C];
  uint32_t owns = 0, writes = 0;
#pragma unroll
  for (int j = 0; j < C; ++j) {
    const int i = lane + 32 * j;
    slot[j] = (i / C) * P + i % C;
    owns |= (uint32_t)(x0 + j < W) << j;
    writes |= (uint32_t)(w * SPAN + i < W) << j;
  }
  // the offset y * W of row step s is o0 + s * dy
  const int o0 = kAsc ? (H - 1) * W : 0, dy = kAsc ? -W : W;

  // row step s's mask and labels; the columns past W keep their initial
  // mask 0 and label kMax
  auto load = [&](int s, int32_t (&mk)[C], int32_t (&lb)[C]) {
    if (s >= H) return;
    const int o = o0 + s * dy;
#pragma unroll
    for (int k = 0; k < C; ++k) {
      if ((owns >> k) & 1) {
        mk[k] = __ldg(pk + o + k);
        lb[k] = kFirst ? o + x0 + k : __ldg(lin + o + k);
      }
    }
  };

  int32_t prev[C];
#pragma unroll
  for (int k = 0; k < C; ++k) prev[k] = kMax;

  // row step s on the row held in (nmk, nlb), which then receives the row
  // two steps ahead; `buf` is the row's parity
  auto step = [&](int s, int32_t (&nmk)[C], int32_t (&nlb)[C], int buf) {
    int32_t mk[C], v[C];
#pragma unroll
    for (int k = 0; k < C; ++k) {
      mk[k] = nmk[k];
      v[k] = nlb[k];
    }
    load(s + 2, nmk, nlb);
    __syncthreads();  // the previous row's warp edges are published

    // inject the previous row through the up-left / up / up-right bits
    int32_t left = __shfl_up_sync(kFull, prev[C - 1], 1);
    int32_t right = __shfl_down_sync(kFull, prev[0], 1);
    if (lane == 0) left = s > 0 && w > 0 ? s_edge[w - 1][1] : kMax;
    if (lane == 31) right = s > 0 && w < kWarps - 1 ? s_edge[w + 1][0] : kMax;
#pragma unroll
    for (int k = 0; k < C; ++k) {
      const int32_t pl = k > 0 ? prev[k - 1] : left;
      const int32_t pr = k < C - 1 ? prev[k + 1] : right;
      v[k] = min(min(v[k], (mk[k] & kUp) ? prev[k] : kMax),
                 min((mk[k] & kUpl) ? pl : kMax, (mk[k] & kUpr) ? pr : kMax));
    }

    // forward (x joins x - 1) and backward (x joins x + 1) segmented min
    // scans over the lane's own columns; wb / eb hold the W / E bits
    int32_t f[C], b[C];
    uint32_t wb = 0, eb = 0;
    {
      int32_t acc = kMax;
#pragma unroll
      for (int k = 0; k < C; ++k) {
        acc = min(v[k], (mk[k] & kW) ? acc : kMax);
        f[k] = acc;
        wb |= (mk[k] & kW) ? 1u << k : 0u;
      }
      acc = kMax;
#pragma unroll
      for (int k = C - 1; k >= 0; --k) {
        acc = min(v[k], (mk[k] & kE) ? acc : kMax);
        b[k] = acc;
        eb |= (mk[k] & kE) ? 1u << k : 0u;
      }
    }
    // the columns whose segment reaches the lane's left edge (the leading
    // run of W bits) and its right edge (the trailing run of E bits)
    const uint32_t fpre = wb & ~(wb + 1);
    const uint32_t ez = ~eb & kAll;
    const uint32_t bpre = ez ? kAll & ~((2u << (31 - __clz(ez))) - 1) : kAll;

    // segmented scans of the lane summaries inside the warp
    // (Hillis-Steele over lanes): forward inclusive from lane 0,
    // backward inclusive from lane 31
    int32_t fv = f[C - 1], bv = b[0];
    int ff = (fpre >> (C - 1)) & 1, bf = bpre & 1;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int32_t fs = __shfl_up_sync(kFull, fv, d);
      const int ffs = __shfl_up_sync(kFull, ff, d);
      const int32_t bs = __shfl_down_sync(kFull, bv, d);
      const int bfs = __shfl_down_sync(kFull, bf, d);
      if (lane >= d) {
        fv = min(fv, ff ? fs : kMax);
        ff &= ffs;
      }
      if (lane + d < 32) {
        bv = min(bv, bf ? bs : kMax);
        bf &= bfs;
      }
    }
    if (lane == 31) { s_sum[w][0] = fv; s_sum[w][1] = ff; }
    if (lane == 0) { s_sum[w][2] = bv; s_sum[w][3] = bf; }
    // lane carries inside the warp (exclusive), before the warp's own
    int32_t fin = __shfl_up_sync(kFull, fv, 1);
    const int finf = __shfl_up_sync(kFull, ff, 1);
    int32_t bin = __shfl_down_sync(kFull, bv, 1);
    const int binf = __shfl_down_sync(kFull, bf, 1);
    __syncthreads();  // the warp summaries are published

    // the carries from the warps to the left / right, folded in order
    int32_t wf = kMax, wbk = kMax;
#pragma unroll
    for (int u = 0; u < kWarps; ++u) {
      if (u < w) wf = min(s_sum[u][0], s_sum[u][1] ? wf : kMax);
      const int r = kWarps - 1 - u;
      if (r > w) wbk = min(s_sum[r][2], s_sum[r][3] ? wbk : kMax);
    }
    fin = lane == 0 ? wf : min(fin, finf ? wf : kMax);
    bin = lane == 31 ? wbk : min(bin, binf ? wbk : kMax);

    int32_t* so = s_out[buf][w];
#pragma unroll
    for (int k = 0; k < C; ++k) {
      prev[k] = min(min(f[k], b[k]), min((fpre >> k) & 1 ? fin : kMax,
                                         (bpre >> k) & 1 ? bin : kMax));
      so[lane * P + k] = prev[k];
    }
    if (lane == 0) s_edge[w][0] = prev[0];
    if (lane == 31) s_edge[w][1] = prev[C - 1];
    __syncwarp();
    int32_t* row = lab + o0 + s * dy;
#pragma unroll
    for (int j = 0; j < C; ++j) {
      if ((writes >> j) & 1) row[32 * j] = so[slot[j]];
    }
  };

  // two rows in flight: the loop is unrolled by two so that each buffer
  // (and each staging buffer) has a name the compiler keeps apart
  int32_t mk0[C], lb0[C], mk1[C], lb1[C];
#pragma unroll
  for (int k = 0; k < C; ++k) {
    mk0[k] = mk1[k] = 0;
    lb0[k] = lb1[k] = kMax;
  }
  load(0, mk0, lb0);
  load(1, mk1, lb1);
  for (int s = 0; s < H; s += 2) {
    step(s, mk0, lb0, 0);
    if (s + 1 < H) step(s + 1, mk1, lb1, 1);
  }
}

// a half pass over grids of any width: one block of kWarps warps per
// image walks each row in groups of kGroup columns, 8 contiguous columns per
// lane, a forward sweep over the groups then a backward one (see the top
// of the file); `in` as for ccl_half_pass, `out` also holds the previous
// row and the current row's forward minima
template <int MODE>
__global__ void __launch_bounds__(32 * kWarps)
    ccl_half_pass_wide(const int32_t* __restrict__ packed,
                       const int32_t* __restrict__ in,
                       int32_t* __restrict__ out, int H, int W) {
  constexpr int C = kMaxCols;
  constexpr int kGroup = kMaxWidth;  // columns per group
  constexpr bool kFirst = MODE == kFirstPass, kAsc = MODE == kAscending;
  constexpr int kUpl = kAsc ? 1 << 5 : 1 << 0;
  constexpr int kUp = kAsc ? 1 << 6 : 1 << 1;
  constexpr int kUpr = kAsc ? 1 << 7 : 1 << 2;
  constexpr uint32_t kAll = (1u << C) - 1;
  // warp summaries, double-buffered by group parity: a buffer is written
  // again only after the next group's barrier, when every thread has read it
  __shared__ int32_t s_sum[2][kWarps][2];

  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int lx = w * 32 * C + lane * C;  // this lane's first column in a group
  const size_t img = (size_t)blockIdx.x * H * W;
  const int32_t* pk = packed + img;
  const int32_t* lin = in + img;
  int32_t* lab = out + img;
  const int groups = (W + kGroup - 1) / kGroup;
  const int o0 = kAsc ? (H - 1) * W : 0, dy = kAsc ? -W : W;
  int par = 0;

  // row offset o, previous row's offset po (none at s = 0), group g:
  // the mask bits and the labels after the injection of the previous row
  auto inject = [&](int o, int po, bool has_prev, int g, int32_t (&mk)[C],
                    int32_t (&v)[C]) {
    const int x0 = g * kGroup + lx;
    int32_t pv[C + 2];
#pragma unroll
    for (int k = 0; k < C + 2; ++k) {
      const int x = x0 + k - 1;
      pv[k] = has_prev && x >= 0 && x < W ? lab[po + x] : kMax;
    }
#pragma unroll
    for (int k = 0; k < C; ++k) {
      const int x = x0 + k;
      mk[k] = 0;
      v[k] = kMax;
      if (x < W) {
        mk[k] = __ldg(pk + o + x);
        v[k] = kFirst ? o + x : __ldg(lin + o + x);
      }
      v[k] = min(min(v[k], (mk[k] & kUp) ? pv[k + 1] : kMax),
                 min((mk[k] & kUpl) ? pv[k] : kMax,
                     (mk[k] & kUpr) ? pv[k + 2] : kMax));
    }
  };

  for (int s = 0; s < H; ++s) {
    const int o = o0 + s * dy, po = o - dy;
    __syncthreads();  // the previous row is written
    int32_t carry = kMax;  // from the groups to the left
    for (int g = 0; g < groups; ++g) {
      int32_t mk[C], v[C], f[C];
      inject(o, po, s > 0, g, mk, v);
      uint32_t wb = 0;
      int32_t acc = kMax;
#pragma unroll
      for (int k = 0; k < C; ++k) {
        acc = min(v[k], (mk[k] & kW) ? acc : kMax);
        f[k] = acc;
        wb |= (mk[k] & kW) ? 1u << k : 0u;
      }
      const uint32_t fpre = wb & ~(wb + 1);
      int32_t fv = f[C - 1];
      int ff = (fpre >> (C - 1)) & 1;
#pragma unroll
      for (int d = 1; d < 32; d <<= 1) {
        const int32_t fs = __shfl_up_sync(kFull, fv, d);
        const int ffs = __shfl_up_sync(kFull, ff, d);
        if (lane >= d) {
          fv = min(fv, ff ? fs : kMax);
          ff &= ffs;
        }
      }
      if (lane == 31) { s_sum[par][w][0] = fv; s_sum[par][w][1] = ff; }
      int32_t fin = __shfl_up_sync(kFull, fv, 1);
      const int finf = __shfl_up_sync(kFull, ff, 1);
      __syncthreads();  // the warp summaries are published
      int32_t wf = carry;
#pragma unroll
      for (int u = 0; u < kWarps; ++u) {
        const int32_t next = min(s_sum[par][u][0], s_sum[par][u][1] ? carry
                                                                    : kMax);
        if (u < w) wf = next;
        carry = next;
      }
      fin = lane == 0 ? wf : min(fin, finf ? wf : kMax);
      const int x0 = g * kGroup + lx;
#pragma unroll
      for (int k = 0; k < C; ++k) {
        if (x0 + k < W)
          lab[o + x0 + k] = min(f[k], (fpre >> k) & 1 ? fin : kMax);
      }
      par ^= 1;
    }
    carry = kMax;  // from the groups to the right
    for (int g = groups - 1; g >= 0; --g) {
      int32_t mk[C], v[C], b[C];
      inject(o, po, s > 0, g, mk, v);
      uint32_t eb = 0;
      int32_t acc = kMax;
#pragma unroll
      for (int k = C - 1; k >= 0; --k) {
        acc = min(v[k], (mk[k] & kE) ? acc : kMax);
        b[k] = acc;
        eb |= (mk[k] & kE) ? 1u << k : 0u;
      }
      const uint32_t ez = ~eb & kAll;
      const uint32_t bpre = ez ? kAll & ~((2u << (31 - __clz(ez))) - 1)
                               : kAll;
      int32_t bv = b[0];
      int bf = bpre & 1;
#pragma unroll
      for (int d = 1; d < 32; d <<= 1) {
        const int32_t bs = __shfl_down_sync(kFull, bv, d);
        const int bfs = __shfl_down_sync(kFull, bf, d);
        if (lane + d < 32) {
          bv = min(bv, bf ? bs : kMax);
          bf &= bfs;
        }
      }
      if (lane == 0) { s_sum[par][w][0] = bv; s_sum[par][w][1] = bf; }
      int32_t bin = __shfl_down_sync(kFull, bv, 1);
      const int binf = __shfl_down_sync(kFull, bf, 1);
      __syncthreads();  // the warp summaries are published
      int32_t wbk = carry;
#pragma unroll
      for (int r = kWarps - 1; r >= 0; --r) {
        const int32_t next = min(s_sum[par][r][0], s_sum[par][r][1] ? carry
                                                                    : kMax);
        if (r > w) wbk = next;
        carry = next;
      }
      bin = lane == 31 ? wbk : min(bin, binf ? wbk : kMax);
      const int x0 = g * kGroup + lx;
#pragma unroll
      for (int k = 0; k < C; ++k) {
        if (x0 + k < W)  // the forward minimum this thread stored above
          lab[o + x0 + k] = min(min(lab[o + x0 + k], b[k]),
                                (bpre >> k) & 1 ? bin : kMax);
      }
      par ^= 1;
    }
  }
}

// one launch per half pass, so that every launch reads labels that are
// read-only for it, ping-ponging between `scratch` and `labels` and ending
// in `labels`
// (C = 0 takes the wide kernel)
template <int C>
cudaError_t launch(const int32_t* packed, int32_t* labels, int32_t* scratch,
                   int B, int H, int W, int passes, cudaStream_t st) {
  for (int p = 0; p < passes; ++p) {
    int32_t* dst = (passes - 1 - p) % 2 ? scratch : labels;
    const int32_t* src = dst == labels ? scratch : labels;
    if constexpr (C == 0) {
      if (p == 0) {
        ccl_half_pass_wide<kFirstPass><<<B, 32 * kWarps, 0, st>>>(
            packed, src, dst, H, W);
      } else if (p & 1) {
        ccl_half_pass_wide<kAscending><<<B, 32 * kWarps, 0, st>>>(
            packed, src, dst, H, W);
      } else {
        ccl_half_pass_wide<kDescending><<<B, 32 * kWarps, 0, st>>>(
            packed, src, dst, H, W);
      }
    } else if (p == 0) {
      ccl_half_pass<C, kFirstPass><<<B, 32 * kWarps, 0, st>>>(
          packed, src, dst, H, W);
    } else if (p & 1) {
      ccl_half_pass<C, kAscending><<<B, 32 * kWarps, 0, st>>>(
          packed, src, dst, H, W);
    } else {
      ccl_half_pass<C, kDescending><<<B, 32 * kWarps, 0, st>>>(
          packed, src, dst, H, W);
    }
    cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return e;
  }
  return cudaSuccess;
}

}  // namespace

extern "C" {

const char* kernel_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// packed (B, H, W) int32 edge bit-plane, labels (B, H, W) int32 output,
// scratch (B, H, W) int32; contiguous on the launching device. Requires
// W >= 1 and H * W < 2^31 (labels are flat int32 indices).
int ccl_raster_launch(const int32_t* packed, int32_t* labels,
                      int32_t* scratch, int B, int H, int W, int passes,
                      void* stream) {
  if (W < 1 || H < 0 || (long long)H * W > kMax)
    return (int)cudaErrorInvalidValue;
  if (W > kMaxWidth)
    return (int)launch<0>(packed, labels, scratch, B, H, W, passes,
                          (cudaStream_t)stream);
  using Launch = cudaError_t (*)(const int32_t*, int32_t*, int32_t*, int,
                                 int, int, int, cudaStream_t);
  const Launch by_cols[kMaxCols] = {launch<1>, launch<2>, launch<3>,
                                    launch<4>, launch<5>, launch<6>,
                                    launch<7>, launch<8>};
  const int c = (W + 32 * kWarps - 1) / (32 * kWarps);  // columns per lane
  return (int)by_cols[c - 1](packed, labels, scratch, B, H, W, passes,
                             (cudaStream_t)stream);
}

}  // extern "C"
