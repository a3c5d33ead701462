// f32 CSR gather-sum for Hopper (sm_90a):
//   out[v] = sum_{e in indptr[v]:indptr[v+1]} x[indices[e]],
// f32 rows summed in f32; a row without edges is written as zeros.
//
// Replaces no TPU kernel: JAX sums the hops of feature_prop (--feature_aug_k)
// in f32 with an XLA segment sum, glnn_tpu/ops/refops.py:37 copy_u_sum under
// glnn_tpu/ops/graph_utils.py:22 feature_prop, which reaches no pallas_call.
// Rounding each message to bf16 would compound over the k hops, so the rows
// stay f32. Caller: glnn_tpu_torch/ops/spmm_cuda.py csr_sum_f32.
//
// Bound on an H100: bytes. Read once, a call moves N * F * 4 bytes of x, the
// E + N + 1 int32 indices and row pointers, and writes N * F * 4 bytes: 0.055
// ms at F = 128 on a graph of ogbn-arxiv's size (N = 169,343, E = 2,537,353)
// at 3.35 TB/s. But the gathers read x once per edge, E * F * 4 bytes (1.30 GB
// there), and x (86.7 MB there) does not fit in the 50 MB L2: if every gather
// missed the L2 the call would take E * F * 4 / 3.35 TB/s = 0.388 ms. The L2's
// hit rate sets where between the two a call lands. The arithmetic, E * F
// adds, is far below the card's rate.
//
// Each edge is an index read, then a read of the source row it names. The
// template body of spmm_csr.cu, run on f32 rows, had one source row in flight
// per warp at F = 128 (VEC 4, 32 lanes, one edge group), so a warp waited one
// device-memory latency per edge, which on a hub row of 20,000 edges is the
// whole kernel; and it left 7 of 32 lanes idle at F = 100. This body:
//   - keeps a ring of kStages stages in shared memory per warp; a stage holds
//     the row slices of G consecutive edges (G x W floats, W the columns of
//     the warp's column chunk), filled with cp.async copies of 16 bytes (8 or
//     4 where F or x's alignment forbids 16: .cg for 16, .ca below). The
//     warp issues stage s + S - 1, waits for stage s
//     (cp.async.wait_group S - 1) and sums it from shared memory, so up to
//     S x G source rows are in flight per warp;
//   - shares a stage's copies out over the 32 lanes flat, pair p = lane + 32 k
//     being (edge p / Q, piece p % Q) with Q = W / VEC pieces a row, so that
//     no lane idles on a copy step but the stage's last (G = 32 * copies / Q
//     edges, `copies` the caller's F32_COPIES: F = 128, 4 x 32 = 128 copies;
//     F = 100, 5 x 25 = 125 over four steps of 32; F = 40, 12 x 10 = 120);
//     the sum reads shared memory, where lane (group g, piece c) adds edges
//     g, g + groups, ... of each stage (groups = 32 / Q; at F = 100 25 lanes
//     sum, from shared memory), and the groups' sums fold at the end;
//   - holds two 32-edge windows of indices in registers (one coalesced read
//     each, the next read 32 edges ahead of use), from which each copying
//     lane takes its edge's source row by __shfl_sync;
//   - cuts F into ceil(F / VEC / 32) column chunks of at most 32 pieces, equal
//     but for the last (F = 256: two of 128; F = 300: three of 100), one warp
//     each (grid y).
// Hub rows: a row of more than kChunkEdges (T) edges is cut into chunks of T
// edges (the last one shorter). The caller lists them (ops/spmm_cuda.py
// hub_plan, built once per graph and cached on the Graph); each chunk is one
// warp's work and writes its f32 partial [F] into scratch that the caller
// allocates, and the chunk warps come first in the grid, so that they start
// first. A second kernel, one warp per split row, sums its partials in chunk
// order and writes the row. No atomics: every sum runs in an order fixed by
// the graph, F, the geometry and the constants, so two launches on the same
// inputs are bit-equal.
//
// Choices (tools/sweep_cuda_kernels.py --kernels f32 on an H100 80GB HBM3 at
// 700 W, device times of one call at F = 128 and 100 on a synth graph of
// ogbn-arxiv's size and on a hub graph with rows of up to 20,000 edges;
// PERF.md section 6):
//   - the ring, S = 2 stages of 4 copies a lane (G = 4 edges at F = 128, 5 at
//     F = 100), over the U-loads form (S = 1: a stage's copies all issued,
//     then waited for and summed, U = G): at the same rows in flight and the
//     same shared memory (S = 1, 8 copies a lane) the two tie, within 2.1%
//     either way on both graphs over two sweeps (the ring ahead in 5 of 8),
//     so the ring stays, and S = 1 runs the U-loads form in the same code;
//     deeper rings (S = 3, 4) gain nothing, and S x G x W x 4 bytes of
//     shared memory a warp (4 KB at F = 128) keep 56 warps resident an SM;
//   - T = 512: on the hub graph T = 128 and 256 were 16% and 6% slower (more
//     partials and a longer second pass), 1,024 level with it;
//   - kCacheHints = 3 takes about 1% off; an evict_last policy on the
//     gathered rows took nothing off, and is not used.
// Every form lands near 0.31 ms at F = 128 on the synth graph, as did the
// template body (one row in flight, 64 warps an SM): the gathers are bound by
// the device memory's rate at the L2's hit rate, not by latency, so the
// design shows on hub rows (7.7 ms to 0.32 on that hub graph), not there.
// ptxas (-Xptxas -v, logged by chip_smoke.py phase 1): 40, 40 and 46
// registers for VEC 1, 2 and 4, no stack frame, no spills.
//
// Interface: plain C, called through ctypes. Both entry points launch on the
// given stream, never synchronise, allocate nothing, and return
// cudaGetLastError(); a geometry the kernel does not take, or a chunk length
// other than kChunkEdges, returns cudaErrorInvalidValue.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kWarps = 8;          // work items per block, one warp each
constexpr int kStages = 2;         // S: the ring's stages per warp
constexpr int kChunkEdges = 512;   // T: longer rows are split into T-edge chunks
constexpr int kMaxCopies = 8;      // copies per lane per stage, at most
constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxSmem = 232448;   // bytes of shared memory a block may use
// L2 hints, bits of kCacheHints: 1 writes the sums evict-first (st.global.cs),
// 2 reads the indices evict-first (ld.global.cs), so that the streams written
// or read once push fewer gathered x rows out of the L2
constexpr int kCacheHints = 3;

template <int VEC> struct Piece;
template <> struct Piece<4> { using T = float4; };
template <> struct Piece<2> { using T = float2; };
template <> struct Piece<1> { using T = float; };

__device__ __forceinline__ void add(float4& a, const float4& b) {
  a.x += b.x;
  a.y += b.y;
  a.z += b.z;
  a.w += b.w;
}
__device__ __forceinline__ void add(float2& a, const float2& b) {
  a.x += b.x;
  a.y += b.y;
}
__device__ __forceinline__ void add(float& a, float b) { a += b; }

__device__ __forceinline__ float4 shfl_down(const float4& v, int d) {
  return make_float4(__shfl_down_sync(kFull, v.x, d), __shfl_down_sync(kFull, v.y, d),
                     __shfl_down_sync(kFull, v.z, d), __shfl_down_sync(kFull, v.w, d));
}
__device__ __forceinline__ float2 shfl_down(const float2& v, int d) {
  return make_float2(__shfl_down_sync(kFull, v.x, d), __shfl_down_sync(kFull, v.y, d));
}
__device__ __forceinline__ float shfl_down(float v, int d) {
  return __shfl_down_sync(kFull, v, d);
}

template <typename V> __device__ __forceinline__ V zero();
template <> __device__ __forceinline__ float4 zero<float4>() { return make_float4(0.f, 0.f, 0.f, 0.f); }
template <> __device__ __forceinline__ float2 zero<float2>() { return make_float2(0.f, 0.f); }
template <> __device__ __forceinline__ float zero<float>() { return 0.f; }

// one lane's copy of VEC floats from device memory into shared memory
template <int VEC>
__device__ __forceinline__ void copy_async(float* dst, const float* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  if constexpr (VEC == 4) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src));
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(s), "l"(src),
                 "n"(VEC * 4));
  }
}

__device__ __forceinline__ int load_index(const int32_t* p) {
  if constexpr (kCacheHints & 2) return __ldcs(p);
  return *p;
}

template <typename V>
__device__ __forceinline__ void store_sum(V* p, const V& v) {
  if constexpr (kCacheHints & 1) {
    __stcs(p, v);
  } else {
    *p = v;
  }
}

__device__ __forceinline__ void commit_stage() { asm volatile("cp.async.commit_group;\n" ::); }

// wait until at most N of this thread's stages are still in flight
template <int N>
__device__ __forceinline__ void wait_stages() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// One warp per work item: hub chunks first (item < n_chunks: the edges
// chunks[item] of a split row, summed into part[item]), then the rows (item -
// n_chunks: a row of at most kChunkEdges edges, summed into out; a longer row
// is left to its chunks). blockIdx.y is the column chunk of `width` columns.
template <int VEC>
__global__ void __launch_bounds__(kWarps * 32)
spmm_f32_kernel(const int32_t* __restrict__ indptr, const int32_t* __restrict__ indices,
                const float* __restrict__ x, const int2* __restrict__ chunks,
                float* __restrict__ part, float* __restrict__ out, int n_rows, int n_chunks,
                int f, int width, int groups, int stage_edges) {
  using V = typename Piece<VEC>::T;
  extern __shared__ __align__(16) float smem[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int item = blockIdx.x * kWarps + warp;
  if (item >= n_chunks + n_rows) return;  // the whole warp leaves together
  int begin, end;
  float* dst;
  if (item < n_chunks) {
    const int2 c = chunks[item];
    begin = c.x;
    end = c.y;
    dst = part + static_cast<int64_t>(item) * f;
  } else {
    const int row = item - n_chunks;
    begin = indptr[row];
    end = indptr[row + 1];
    if (end - begin > kChunkEdges) return;  // its chunks sum it
    dst = out + static_cast<int64_t>(row) * f;
  }
  const int q = width / VEC;  // pieces of a row slice
  const int col0 = blockIdx.y * width;
  const int stage_len = stage_edges * width;
  float* ring = smem + static_cast<int64_t>(warp) * kStages * stage_len;

  // this lane's copies of a stage: pair p = lane + 32 k is (edge p / q, piece
  // p % q); from one copy to the next p grows by 32 = dj * q + dc
  const int copies = (stage_edges * q + 31) / 32;
  const int j0 = lane / q, c0 = lane - j0 * q;
  const int dj = 32 / q, dc = 32 - dj * q;
  // two windows of indices, [w0, w0 + 32) in ia and [w0 + 32, w0 + 64) in ib
  int w0 = begin & ~31;
  int ia = w0 + lane >= begin && w0 + lane < end ? load_index(indices + w0 + lane) : 0;
  int ib = w0 + 32 + lane < end ? load_index(indices + w0 + 32 + lane) : 0;
  const int n_stages = (end - begin + stage_edges - 1) / stage_edges;

  // stages are produced in order, so s0 - w0 < 32 + stage_edges <= 64 and one
  // slide of the windows is enough
  auto produce = [&](int s) {
    const int s0 = begin + s * stage_edges;
    if (s0 - w0 >= 32) {
      ia = ib;
      w0 += 32;
      ib = w0 + 32 + lane < end ? load_index(indices + w0 + 32 + lane) : 0;
    }
    const int n = min(stage_edges, end - s0);
    float* slot = ring + (s % kStages) * stage_len;
    int j = j0, c = c0;
#pragma unroll
    for (int k = 0; k < kMaxCopies; ++k) {
      if (k < copies) {  // warp-uniform
        const int rel = s0 + j - w0;
        const int sa = __shfl_sync(kFull, ia, rel & 31);
        const int sb = __shfl_sync(kFull, ib, rel & 31);
        const int col = col0 + c * VEC;
        if (j < n && col < f)
          copy_async<VEC>(slot + j * width + c * VEC,
                          x + static_cast<int64_t>(rel < 32 ? sa : sb) * f + col);
        j += dj;
        c += dc;
        if (c >= q) {
          c -= q;
          ++j;
        }
      }
    }
  };

  // lane (group grp, piece pc) sums edges grp, grp + groups, ... of a stage
  const int grp = lane / q;
  const int pc = lane - grp * q;
  const int col = col0 + pc * VEC;
  const bool active = grp < groups && col < f;
  V acc = zero<V>();
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < n_stages) produce(s);
    commit_stage();
  }
  for (int s = 0; s < n_stages; ++s) {
    if (s + kStages - 1 < n_stages) produce(s + kStages - 1);
    commit_stage();
    wait_stages<kStages - 1>();  // stage s has landed
    __syncwarp();                // and the other lanes' copies are visible
    const int n = min(stage_edges, end - (begin + s * stage_edges));
    const float* slot = ring + (s % kStages) * stage_len + pc * VEC;
    if (active) {
      for (int j = grp; j < n; j += groups) add(acc, *reinterpret_cast<const V*>(slot + j * width));
    }
    __syncwarp();  // the slot is read before a later stage refills it
  }

  // fold the groups' sums onto group 0: groups [h, s) onto [0, s - h)
  for (int s = groups; s > 1;) {
    const int h = (s + 1) >> 1;
    const V o = shfl_down(acc, h * q);
    if (grp + h < s) add(acc, o);
    s = h;
  }
  if (active && grp == 0) store_sum(reinterpret_cast<V*>(dst + col), acc);
}

// One warp per split row s: out[rows[s]] = the sum of part[first[s]] ...
// part[first[s + 1] - 1], in chunk order.
__global__ void __launch_bounds__(kWarps * 32)
spmm_f32_combine_kernel(const int32_t* __restrict__ rows, const int32_t* __restrict__ first,
                        const float* __restrict__ part, float* __restrict__ out, int n_split,
                        int f) {
  const int lane = threadIdx.x & 31;
  const int s = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (s >= n_split) return;
  const int k0 = first[s], k1 = first[s + 1];
  float* o = out + static_cast<int64_t>(rows[s]) * f;
  for (int col = lane; col < f; col += 32) {
    float acc = 0.f;
#pragma unroll 4
    for (int k = k0; k < k1; ++k) acc += part[static_cast<int64_t>(k) * f + col];
    o[col] = acc;
  }
}

template <int VEC>
int launch_vec(const int32_t* indptr, const int32_t* indices, const float* x, const int2* chunks,
               float* part, float* out, int n_rows, int n_chunks, int f, int width, int groups,
               int stage_edges, cudaStream_t stream) {
  const int smem = kWarps * kStages * stage_edges * width * static_cast<int>(sizeof(float));
  if (smem > kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
  static int smem_allowed = 48 * 1024;  // the default; raised once where needed
  if (smem > smem_allowed) {
    const cudaError_t err = cudaFuncSetAttribute(
        spmm_f32_kernel<VEC>, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
    if (err != cudaSuccess) return static_cast<int>(err);
    smem_allowed = kMaxSmem;
  }
  const dim3 grid((n_chunks + n_rows + kWarps - 1) / kWarps, (f + width - 1) / width);
  spmm_f32_kernel<VEC><<<grid, kWarps * 32, smem, stream>>>(
      indptr, indices, x, chunks, part, out, n_rows, n_chunks, f, width, groups, stage_edges);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// x f32 [*, f], out f32 [n_rows, f]; chunks int32 [n_chunks, 2] (each hub
// chunk's edge range), part f32 [n_chunks, f] its partials; (vec, width,
// groups, stage_edges) as ops/spmm_cuda.py f32_geometry gives them, and
// chunk_edges the T that the chunks were cut with.
int spmm_csr_f32(const void* indptr, const void* indices, const void* x, const void* chunks,
                 void* part, void* out, int n_rows, int n_chunks, int f, int vec, int width,
                 int groups, int stage_edges, int chunk_edges, void* stream) {
  if (n_rows < 0 || n_chunks < 0 || f <= 0 || chunk_edges != kChunkEdges)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n_rows + n_chunks == 0) return static_cast<int>(cudaGetLastError());
  const uintptr_t align = static_cast<uintptr_t>(vec) * sizeof(float);
  const bool ok =
      (vec == 1 || vec == 2 || vec == 4) && f % vec == 0 &&
      reinterpret_cast<uintptr_t>(x) % align == 0 &&
      reinterpret_cast<uintptr_t>(out) % align == 0 &&
      (n_chunks == 0 || (reinterpret_cast<uintptr_t>(part) % align == 0 && chunks != nullptr)) &&
      width >= vec && width % vec == 0 && width / vec <= 32 && groups >= 1 &&
      groups * (width / vec) <= 32 && stage_edges >= 1 && stage_edges <= 32 &&
      (stage_edges * (width / vec) + 31) / 32 <= kMaxCopies && (f + width - 1) / width <= 65535;
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  const auto* ip = static_cast<const int32_t*>(indptr);
  const auto* ix = static_cast<const int32_t*>(indices);
  const auto* xf = static_cast<const float*>(x);
  const auto* ch = static_cast<const int2*>(chunks);
  auto* pt = static_cast<float*>(part);
  auto* o = static_cast<float*>(out);
  const auto st = static_cast<cudaStream_t>(stream);
  switch (vec) {
    case 4:
      return launch_vec<4>(ip, ix, xf, ch, pt, o, n_rows, n_chunks, f, width, groups, stage_edges, st);
    case 2:
      return launch_vec<2>(ip, ix, xf, ch, pt, o, n_rows, n_chunks, f, width, groups, stage_edges, st);
    default:
      return launch_vec<1>(ip, ix, xf, ch, pt, o, n_rows, n_chunks, f, width, groups, stage_edges, st);
  }
}

// rows int32 [n_split] (the split rows), first int32 [n_split + 1] (row s's
// partials are part[first[s]:first[s + 1]]), part f32 [*, f], out f32 [*, f]
int spmm_csr_f32_combine(const void* rows, const void* first, const void* part, void* out,
                         int n_split, int f, void* stream) {
  if (n_split < 0 || f <= 0) return static_cast<int>(cudaErrorInvalidValue);
  if (n_split == 0) return static_cast<int>(cudaGetLastError());
  spmm_f32_combine_kernel<<<(n_split + kWarps - 1) / kWarps, kWarps * 32, 0,
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(rows), static_cast<const int32_t*>(first),
      static_cast<const float*>(part), static_cast<float*>(out), n_split, f);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
