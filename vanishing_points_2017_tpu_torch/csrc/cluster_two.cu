// Masked average-linkage 2-clustering for Hopper (sm_90a): kernel K3.
//
// Replaces no TPU kernel. The JAX package runs this loop as a
// lax.while_loop (vanishing_points_2017_tpu/em/cluster.py), which XLA keeps
// on the device; the port ran it as a host loop, one device-to-host read
// and ~35 launches over the whole padded (B, N, N) matrix per merge step.
// Same function as the plain twin em/cluster.py::agglomerative_two_ref, bit
// for bit, for every input: per image, while more than two of its active
// items remain as clusters, merge the pair (i, j) at the flat row-major
// argmin of the distance matrix d (torch.argmin's order: NaN first, ties to
// the lower index), row and column i become
// (n_i d[i, :] + n_j d[j, :]) / (n_i + n_j), row and column j and the
// diagonal become BIG (1e12), and the items labelled j take the label i.
// Returns, per item, whether it is active and shares the label of the
// image's first active item.
//
// What bounds it: the chain of n_a - 2 dependent merge steps of an image
// with n_a active items, each a block-wide argmin, a row update and two
// block barriers; the bytes (the gathered n_a^2 distances) are ~0.2 MB a
// batch at the main path's sizes, under a microsecond at 3.35 TB/s.
// What the design does about it: one block per image runs the whole loop,
// so nothing waits on the host and no launch is repeated. The block
// compacts the image's active items in index order (a ballot prefix sum)
// and gathers their rows and columns of dist into an n_a x n_a matrix,
// kept in shared memory when it fits (cap x cap, cap from the card's
// opt-in limit: 234 at N = 512) and otherwise in the image's slice of a
// global scratch (L2-resident), chosen per image from its own n_a. Each
// step scans the compacted matrix (a warp per row), reduces to the block's
// argmin and rewrites one row and column.
//
// Exactness. Candidates carry their flat index in the full N x N matrix
// (o[row] * N + o[col]), so the compacted scan picks what torch.argmin
// picks over the whole matrix. The entries of the inactive items are kept
// without storing them: an inactive item k that no step has picked has
// d[s, k] = d[k, s] = p[s] for every compacted item s (the same value for
// every such k: BIG, then updated with row s) and BIG against the other
// inactive items, so the first such item f stands for all of them in the
// scan (row f, column f). Where the argmin picks f (only where every
// active pair reads about BIG or more), f joins the compacted items, and
// the matrix moves to the global slice if shared memory is full. The
// update is the twin's separate round-to-nearest operations in its order
// (__fmul_rn, __fadd_rn, __fdiv_rn; built with -fmad=false besides), on
// every compacted column, retired ones included, as the twin updates the
// whole row.

#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;
constexpr float kBig = 1e12f;

// 32-bit words of the shared header before the matrix: per item p, size,
// new row, original index, compacted slot and label; the reduction's
// values and indices; 4 words of state. Rounded to 16 bytes.
__host__ __device__ constexpr long long header_words(long long n) {
  return (6 * n + 2 * kWarps + 4 + 3) / 4 * 4;
}

// torch.argmin's order (LessOrNan): NaN first, then the smaller value,
// equal values to the lower flat index.
__device__ __forceinline__ bool before(float va, int ia, float vb, int ib) {
  if (isnan(va)) return isnan(vb) ? ia < ib : true;
  if (isnan(vb)) return false;
  return va == vb ? ia < ib : va < vb;
}

__device__ __forceinline__ void keep(float v, int at, float& bv, int& bi) {
  if (before(v, at, bv, bi)) {
    bv = v;
    bi = at;
  }
}

__device__ __forceinline__ void warp_min(float& bv, int& bi) {
  for (int off = 16; off; off >>= 1) {
    const float v = __shfl_down_sync(kFull, bv, off);
    const int at = __shfl_down_sync(kFull, bi, off);
    keep(v, at, bv, bi);
  }
}

// grid B, kThreads threads, header_words(N) + cap * cap words of shared
// memory; scratch (B, N, N) when cap < N
__global__ void __launch_bounds__(kThreads)
    cluster_two(const float* __restrict__ dist,
                const unsigned char* __restrict__ active,
                unsigned char* __restrict__ out, float* scratch, int N,
                int cap) {
  extern __shared__ float smem[];
  float* p = smem;      // phantom entry d[s, k] of the unpicked inactive k
  float* sz = p + N;    // cluster sizes
  float* nr = sz + N;   // the merged row
  int* o = reinterpret_cast<int*>(nr + N);  // slot -> item
  int* slot_of = o + N;                     // item -> slot, -1 if none
  int* label = slot_of + N;                 // slot -> label (an item)
  float* red_v = reinterpret_cast<float*>(label + N);
  int* red_i = reinterpret_cast<int*>(red_v + kWarps);
  int* state = red_i + kWarps;  // [0] f, [1] the argmin's flat index
  int* warp_cnt = red_i;        // the compaction's counts, before any step
  float* dsh = smem + header_words(N);

  const int b = blockIdx.x;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const float* db = dist + (size_t)b * N * N;
  const unsigned char* ab = active + (size_t)b * N;

  // ---- compact the active items in index order; f = first inactive item
  if (tid == 0) state[0] = N;
  __syncthreads();
  int na = 0;
  for (int k0 = 0; k0 < N; k0 += kThreads) {
    const int k = k0 + tid;
    const bool a = k < N && ab[k] != 0;
    const unsigned m = __ballot_sync(kFull, a);
    if (lane == 0) warp_cnt[warp] = __popc(m);
    if (k < N && !a) atomicMin(&state[0], k);
    __syncthreads();
    int off = na, all = 0;
    for (int w = 0; w < kWarps; ++w) {
      if (w < warp) off += warp_cnt[w];
      all += warp_cnt[w];
    }
    if (a) {
      const int s = off + __popc(m & ((1u << lane) - 1u));
      o[s] = k;
      slot_of[k] = s;
    } else if (k < N) {
      slot_of[k] = -1;
    }
    na += all;
    __syncthreads();
  }
  for (int s = tid; s < na; s += kThreads) {
    p[s] = kBig;
    sz[s] = 1.0f;
    label[s] = o[s];
  }
  bool in_shared = na <= cap;
  int ld = in_shared ? cap : N;
  float* d = in_shared ? dsh : scratch + (size_t)b * N * N;
  for (int r = warp; r < na; r += kWarps) {
    const float* src = db + (size_t)o[r] * N;
    for (int c = lane; c < na; c += 32)
      d[(size_t)r * ld + c] = c == r ? kBig : src[o[c]];
  }

  // ---- the merge steps
  int ns = na;
  for (int step = 0; step < na - 2; ++step) {
    __syncthreads();
    const int f = state[0];
    float bv = INFINITY;
    int bi = INT_MAX;
    for (int r = warp; r < ns; r += kWarps) {
      const float* row = d + (size_t)r * ld;
      const int ro = o[r] * N;
      for (int c = lane; c < ns; c += 32) keep(row[c], ro + o[c], bv, bi);
    }
    if (f < N) {
      for (int t = tid; t < ns; t += kThreads) {
        keep(p[t], o[t] * N + f, bv, bi);  // row t, column f
        keep(p[t], f * N + o[t], bv, bi);  // row f, column t
      }
      if (tid == 0) keep(kBig, f * N + f, bv, bi);
    }
    warp_min(bv, bi);
    if (lane == 0) {
      red_v[warp] = bv;
      red_i[warp] = bi;
    }
    __syncthreads();
    if (warp == 0) {
      bv = lane < kWarps ? red_v[lane] : INFINITY;
      bi = lane < kWarps ? red_i[lane] : INT_MAX;
      warp_min(bv, bi);
      if (lane == 0) state[1] = bi;
    }
    __syncthreads();
    const int at = state[1];
    const int io = at / N, jo = at - io * N;

    if (slot_of[io] < 0 || slot_of[jo] < 0) {
      // the argmin picked the inactive item f: it joins the slots, with
      // d[f, s] = d[s, f] = p[s], BIG on its diagonal and against the
      // other inactive items
      if (in_shared && ns == cap) {
        float* g = scratch + (size_t)b * N * N;
        for (int r = warp; r < ns; r += kWarps)
          for (int c = lane; c < ns; c += 32)
            g[(size_t)r * N + c] = d[(size_t)r * ld + c];
        __syncthreads();
        d = g;
        ld = N;
        in_shared = false;
      }
      for (int t = tid; t < ns; t += kThreads) {
        d[(size_t)ns * ld + t] = p[t];
        d[(size_t)t * ld + ns] = p[t];
      }
      if (tid == 0) {
        d[(size_t)ns * ld + ns] = kBig;
        p[ns] = kBig;
        sz[ns] = 1.0f;
        label[ns] = f;
        o[ns] = f;
        slot_of[f] = ns;
        int g = f + 1;
        while (g < N && slot_of[g] >= 0) ++g;
        state[0] = g;
      }
      ++ns;
      __syncthreads();
    }

    // merge j into i, in the twin's operations and order
    const int si = slot_of[io], sj = slot_of[jo];
    const float ni = sz[si], nj = sz[sj];
    const float den = __fadd_rn(ni, nj);
    const float* ri = d + (size_t)si * ld;
    const float* rj = d + (size_t)sj * ld;
    for (int t = tid; t < ns; t += kThreads)
      nr[t] = __fdiv_rn(__fadd_rn(__fmul_rn(ni, ri[t]), __fmul_rn(nj, rj[t])),
                        den);
    const float np = __fdiv_rn(
        __fadd_rn(__fmul_rn(ni, p[si]), __fmul_rn(nj, p[sj])), den);
    __syncthreads();
    for (int t = tid; t < ns; t += kThreads) {
      const float v = (t == si || t == sj || si == sj) ? kBig : nr[t];
      d[(size_t)si * ld + t] = v;
      d[(size_t)t * ld + si] = v;
      d[(size_t)sj * ld + t] = kBig;
      d[(size_t)t * ld + sj] = kBig;
      if (label[t] == jo) label[t] = io;
    }
    if (tid == 0) {
      p[si] = si == sj ? kBig : np;
      p[sj] = kBig;
      sz[si] = den;
    }
  }
  __syncthreads();

  // ---- the cluster of the first active item (slot 0)
  const int first = na > 0 ? label[0] : -1;
  unsigned char* ob = out + (size_t)b * N;
  for (int k = tid; k < N; k += kThreads)
    ob[k] = ab[k] != 0 && label[slot_of[k]] == first;
}

}  // namespace

extern "C" {

const char* kernel_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// dist (B, N, N) f32, active (B, N) bool, out (B, N) bool, scratch (B, N, N)
// f32; all contiguous on the current device.
int cluster_two_launch(const float* dist, const unsigned char* active,
                       unsigned char* out, float* scratch, int B, int N,
                       void* stream) {
  if (B < 1 || N < 1 || (long long)N * N > INT_MAX)
    return (int)cudaErrorInvalidValue;
  int dev = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                               dev);
  if (err != cudaSuccess) return (int)err;
  const long long room = optin / 4 - header_words(N);
  if (room < 9) return (int)cudaErrorInvalidValue;
  long long cap = (long long)sqrt((double)room);
  while (cap * cap > room) --cap;
  while ((cap + 1) * (cap + 1) <= room) ++cap;
  if (cap > N) cap = N;
  const size_t bytes = 4 * (size_t)(header_words(N) + cap * cap);
  err = cudaFuncSetAttribute(cluster_two,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)bytes);
  if (err != cudaSuccess) return (int)err;
  cluster_two<<<B, kThreads, bytes, (cudaStream_t)stream>>>(
      dist, active, out, scratch, N, (int)cap);
  return (int)cudaGetLastError();
}

}  // extern "C"
