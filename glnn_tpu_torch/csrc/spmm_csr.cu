// CSR gather-reduce SpMM for Hopper (sm_90a): out[v] = sum_{e in row v} x[idx[e]].
//
// Replaces the TPU kernels glnn_tpu/ops/spmm_pallas.py:_block_kernel (:93)
// and :_kernel (:59). Those build a one-hot [d, X] matrix per dst block and
// reduce pre-gathered message rows on the MXU, because the TPU has no fast
// scatter and no fast in-core row gather. Hopper has both a fast random row
// read (L2-backed) and a register file per thread, so the gather and the
// reduction are fused here: the edges are dst-sorted, each dst row (each
// T-edge chunk of a hub row, below) is owned by exactly one warp, and the
// warp walks its edges reading x rows and summing in registers. No one-hot, no atomics, no message tensor in
// device memory.
//
// Bound on an H100: bytes. Per call the kernel must read the x rows it
// gathers (E * F * itemsize bytes, most of them hits in the 50 MB L2 when x
// fits there, as ogbn-arxiv's 169k x 256 bf16 does), the E int32 indices and
// the indptr once, and write N * F * 4 bytes of f32 output. Its arithmetic
// (E * F adds) is far below the card's rate. What holds a warp back is the
// latency of its gathers: each edge is an index, then a row read that depends
// on it. The design keeps many wide, independent row reads in flight:
//   - VEC, the widest load of at most 16 bytes and 8 elements that divides F
//     (and, weighted, the head width D) with every row aligned, is one lane's
//     slice of a row (16 int8 elements measured slower: twice the
//     accumulators, and twice the shuffles where the groups' sums merge);
//     L = ceil(F / VEC) lanes (at most 32) cover a row's columns;
//   - the lanes lie across (edge, column group) pairs: G = 32 / L groups of L
//     lanes each take every G-th edge of the row, so G rows are read at once
//     (F = 40: VEC 8 and G = 6 in bf16 and int8, VEC 4 and G = 3 in f32;
//     F = 64 bf16: VEC 8, G = 4; F = 128 f32: VEC 4, G = 1);
//   - 64 warps per SM (the register budget is 32), so that many rows are in
//     flight at once, and few instructions per step: no division in the
//     loop, no loop over column chunks, and an int8 element is sign-extended
//     by two shifts, the second fused into its add (issuing two steps' reads
//     before summing either gained nothing for the unweighted sums; the
//     weighted walk does, below);
//   - each group keeps its own partial sum, and the groups' partials merge
//     with __shfl_down_sync at the row's end, so a row takes one pass over its
//     edges at every width up to 32 * VEC; wider rows (G = 1) are split into
//     chunks of 32 * VEC columns, one warp each (the grid's y);
//   - the warp loads 32 indices with one coalesced read and hands them out
//     with __shfl_sync (the weighted walk through shared memory, below).
// Hub rows are split across warps, the counterpart of the tiled TPU kernel
// (spmm_pallas.py:_kernel), which bounds each grid step at one tile of edges
// whatever a row's degree and accumulates a hub row's tiles into one output
// (is_first, :60-90). A row of more than T edges is cut into T-edge chunks
// (the last one shorter), which the caller lists once per CSR
// (ops/spmm_cuda.py hub_plan, kept on the Graph, the halo shard or the
// WeightedCSR). One warp per chunk runs the same walk over the chunk's edge
// range and writes its partial sum, unscaled (f32; int32 for the int8
// policy, exact in any order, so the dequantisation happens once, after the
// sum); the chunk warps come first in the grid, so that they start first,
// and a row warp leaves a row of more than T edges to its chunks. A second
// kernel, one warp per split row, sums the row's partials in chunk order
// and writes the row (wide rows: one partial per chunk and column chunk).
// A row of at most T edges is walked and summed by one warp, as every row of
// a CSR without hub rows. No atomics: every sum runs in an order fixed by
// the CSR, T and the geometry, so two launches on the same inputs are
// bit-equal. The walk is built twice, with and without the chunk items
// (HUB), and a plan without chunks runs the instantiation without, which
// holds no chunk state (synth-graph device times within 1% of the walk with
// no chunk code, tools/hub_kernel_times.py).
// T is the caller's (ops/spmm_cuda.py HUB_CHUNK; the kernel takes any T >= 1,
// and the plan passed must have been cut with it): T = 512, from
// tools/sweep_cuda_kernels.py --kernels spmm_hub on an H100 80GB HBM3 at
// 700 W (device ms on chip_smoke.py's hub graph, rows of up to 20,000
// edges): at F = 40 bf16 0.0713 against 0.0778 at T = 256 and 0.0734 at
// 1,024, int8 0.0762 against 0.0901 and 0.0729, weighted 0.1167 against
// 0.1238 and 0.1772; at F = 128 512 is best for bf16 and int8 and 4% behind
// 256 for the weighted sum; 64 edges per edge group (384 at F = 40) is no
// better. Shorter chunks add partials and lengthen the second pass; longer
// ones leave a chunk's warp running after the walk. It is the f32 sum's T
// as well, so one plan per CSR serves every kernel that splits rows.
//
// The geometry (VEC, L, G) is worked out by the caller (ops/spmm_cuda.py
// `geometry`) and checked here: an entry point returns cudaErrorInvalidValue
// for a geometry that it does not instantiate or that would misalign a row.
//
// Three instantiations of one kernel body, told apart by a policy type that
// says what a gathered element adds to the sum and how the sum is written
// (the f32 sum of feature_prop's hops has a body of its own, spmm_f32.cu):
//   exact:    bf16 rows, f32 accumulation, f32 output;
//   int8:     int8 rows, int32 accumulation (exact in any order), output
//             acc * scale[f] in f32 (the per-column dequantisation of
//             spmm_pallas.py:408-414);
//   weighted: the counterpart of the same TPU kernels under
//             spmm_pallas.u_mul_e_sum (:438, messages built at :288-310):
//             out[v] = sum_{e in row v} bf16(x[idx[e]] * w[widx(e)]) in f32.
//             x is f32 [*, H*D]; w is f32 [E, H] (H = 1: one scalar per
//             edge), and lane column c takes the weight of head c / D. As
//             JAX does, the product is formed in f32 and rounded once to
//             bf16 before the sum, so the rows stay f32. widx(e) is e on the
//             forward walk (the weights are in dst-sorted edge order); on the
//             transposed walk (t_indptr, t_receivers) the caller passes
//             t_edges, and the kernel reads the dst-ordered weights through
//             it, so no permuted copy of w and no [E, F] message tensor
//             exist. Its VEC also divides D, so that a lane's columns share
//             one head.
//
// The weighted walk gathers only the edges it keeps. APPNP's training hops
// drop half the edges (a weight of exactly 0), and a dropped edge adds
// bf16(x * 0) = +-0 to a sum that starts at +0, which leaves it as it is.
// So with one weight per edge, each lane reads its edge's weight with its
// index (through t_edges on the transposed walk), the warp takes a ballot
// of the lanes whose weight is not 0, and each kept lane writes its source
// and weight into shared memory at its rank among the kept lanes; the
// groups then step over the m kept edges only, kept edge r by group r % G,
// two steps at a time (both rows' reads issued before either is summed:
// with no index, slot or norm held in registers across the steps this
// fits the 32 registers without spilling). A window with no weight of 0
// walks every edge in the order it always did, so dense weights give the
// same bits; with edges dropped the kept terms are summed in another order
// across the groups. A non-finite row on a dropped edge's source no longer
// reaches the sum (inf * 0 made a NaN there). With several heads every
// edge is gathered, its weights read in the step. Timed on the APPNP
// cell's graph at F = 40 (tools/time_weighted_walks.py, an H100 80GB HBM3
// at 700 W, device ms forward / transposed): 0.198 / 0.215 before, 0.135 /
// 0.141 with half the weights 0, 0.183 / 0.197 with none; one step at a
// time 0.148 / 0.155; the compaction by __fns and shuffles instead of
// shared memory 0.162 / 0.178 (norms read in the window, where shared
// memory gave 0.153 / 0.161). The walk adds each work item's gathered
// edges to `gathered[item]` where the caller passes that buffer (only
// while a profiler runs), one plain add by lane 0 of the item's warp.
//
// APPNP's hop (nn/layers.py appnp_propagate), h' = c1 * D_in^-1/2 A_w
// D_out^-1/2 h + c2 * h0 with c1 = 1 - alpha and c2 = alpha in f32, runs
// inside the walk of its sum as a second template argument of both kernels
// (the hop, after the policy; NoHop for the plain sums, whose code it leaves
// as it is). It adds a norm of each gathered row, read in the step beside
// the row (kept edges only; one address for the group's lanes), and an
// epilogue of each written
// row (the walk's and the split rows' sum's), so that none of the hop's
// elementwise ops runs as a kernel of its own. Every step is one f32
// operation rounded as the torch op it replaces (__fmul_rn / __fadd_rn, so
// nothing is contracted into an FMA), and the sums run in the walk's order,
// so a fused hop is bit-equal to the composition of the plain sum and those
// ops:
//   forward (weighted):    message bf16((x[u] * s[u]) * w[e]); row
//                          ((acc * d[v]) * c1) + (c2 * h0[v]);
//   transposed (weighted): the backward's dX: message bf16(((g[v] * c1) *
//                          d[v]) * w[e]) over the transposed CSR; row acc *
//                          s[u];
//   eval (int8): the rows quantised from h * s as the int8 tier does; row
//                          (((acc * scale[col]) * d[v]) * c1) + (c2 *
//                          h0[v]);
// s = rsqrt(max(out-degree, 1)) and d = rsqrt(max(in-degree, 1)), the
// norms kept on the Graph (ops/refops.py degree_norms).
//
// Interface: plain C, called through ctypes. Every entry point launches on
// the given stream, never synchronises, allocates nothing (the caller
// allocates the partials), and returns cudaGetLastError() so that a refused
// launch is reported to the caller. Each policy has two entry points: the
// walk (spmm_csr_bf16, _int8, _weighted) and the sum of the split rows'
// partials (spmm_csr_bf16_combine, ...), launched only when the plan has
// chunks.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

namespace {

constexpr int kWarps = 8;   // work items (rows or chunks) per block, one warp each
constexpr unsigned kFull = 0xffffffffu;

// the type of one lane's load of BYTES bytes, and the register it is held in
// (a 32-bit word for loads narrower than one)
template <int BYTES> struct VecOf;
template <> struct VecOf<16> { using T = uint4; using R = uint4; };
template <> struct VecOf<8> { using T = uint2; using R = uint2; };
template <> struct VecOf<4> { using T = unsigned int; using R = unsigned int; };
template <> struct VecOf<2> { using T = unsigned short; using R = unsigned int; };
template <> struct VecOf<1> { using T = unsigned char; using R = unsigned int; };

// the i-th 32-bit word of a loaded vector (i is a constant after unrolling),
// so that no local variable has its address taken
template <typename V>
__device__ __forceinline__ unsigned word(const V& v, int i) {
  if constexpr (sizeof(V) == 16) {
    return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
  } else if constexpr (sizeof(V) == 8) {
    return i == 0 ? v.x : v.y;
  } else {
    return static_cast<unsigned>(v);
  }
}

// element k of a loaded vector, widened: bf16 and f32 to float, int8 to int
template <typename TIn, typename V>
__device__ __forceinline__ auto element(const V& v, int k) {
  if constexpr (std::is_same_v<TIn, float>) {
    return __uint_as_float(word(v, k));
  } else if constexpr (std::is_same_v<TIn, __nv_bfloat16>) {
    const unsigned w = word(v, k >> 1);
    return __uint_as_float((k & 1) ? (w & 0xffff0000u) : (w << 16));
  } else {  // the byte moved to the top, then shifted down with its sign
    return static_cast<int>(word(v, k >> 2) << (24 - 8 * (k & 3))) >> 24;
  }
}

__device__ __forceinline__ float finish(float acc, const float*, int) { return acc; }
__device__ __forceinline__ float finish(int acc, const float* scale, int col) {
  return static_cast<float>(acc) * scale[col];
}

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16(v));
}

// unweighted sums: each element as it is (bf16 -> f32, int8 -> int32); the
// int8 tier scales each column's exact sum on the way out
template <typename TIn_, typename TAcc_>
struct Sum {
  using TIn = TIn_;
  using TAcc = TAcc_;
  static constexpr bool kWeighted = false;
  const float* scale;  // int8 tier: f32 [f]; null for the exact tier

  bool fits(int) const { return true; }
  __device__ int head(int) const { return 0; }
  __device__ int slot(int) const { return 0; }
  __device__ float weight(int, int) const { return 1.f; }
  __device__ TAcc term(TAcc v, float) const { return v; }
  __device__ float out(TAcc acc, int col) const { return finish(acc, scale, col); }
};

// weighted sum: f32 elements times their edge's (and head's) weight, each
// product rounded once to bf16
struct Weighted {
  using TIn = float;
  using TAcc = float;
  static constexpr bool kWeighted = true;
  const int32_t* widx;  // weight index of each CSR slot, or null: the slot
  const float* w;       // f32 [E, heads]
  int heads;
  int d;                // f / heads, the width of one head
  int32_t* gathered;    // per work item, the edges it gathered, added to; or null

  bool fits(int vec) const { return d % vec == 0; }  // a lane's columns share a head
  __device__ int head(int col) const { return col / d; }
  __device__ int slot(int e) const { return widx != nullptr ? widx[e] : e; }
  __device__ float weight(int slot, int head) const {
    return w[static_cast<int64_t>(slot) * heads + head];
  }
  __device__ float term(float v, float wv) const { return round_bf16(v * wv); }
  __device__ float out(float acc, int) const { return acc; }
};

// The plain sums: nothing before the policy's term, nothing after its out.
struct NoHop {
  static constexpr bool kGather = false;  // no norm of the gathered rows
  bool fits(int, uintptr_t) const { return true; }
  template <typename T>
  __device__ T in(T v, float) const { return v; }
  __device__ float row(int) const { return 1.f; }
  __device__ float out(float v, float, int64_t) const { return v; }
  __device__ float4 out4(float4 v, float, int64_t) const { return v; }
};

// APPNP's hop, one of three passes (see the note at the top).
constexpr int kHopForward = 0, kHopTransposed = 1, kHopEval = 2;
template <int PASS>
struct Appnp {
  static constexpr bool kGather = PASS != kHopEval;
  static constexpr bool kTeleport = PASS != kHopTransposed;
  const float* gather_norm;  // of the gathered rows: s forward, d transposed
  const float* row_norm;     // of the written rows: d forward and eval, s transposed
  const float* h0;           // f32 [n_rows, f], forward and eval
  float c1, c2;              // float(1 - alpha), float(alpha)

  // h0 is read as the rows are written: float4 for a VEC of 4 or 8
  bool fits(int vec, uintptr_t h0_addr) const {
    return !kTeleport || h0_addr % (vec % 4 == 0 ? 16 : 4) == 0;
  }
  __device__ float gather(int u) const { return gather_norm[u]; }
  template <typename T>
  __device__ T in(T v, float norm) const {
    if constexpr (PASS == kHopForward) return __fmul_rn(v, norm);
    else if constexpr (PASS == kHopTransposed) return __fmul_rn(__fmul_rn(v, c1), norm);
    else return v;
  }
  __device__ float row(int r) const { return row_norm[r]; }
  __device__ float teleport(float v, float norm, float h) const {
    return __fadd_rn(__fmul_rn(__fmul_rn(v, norm), c1), __fmul_rn(c2, h));
  }
  // at: the element's offset in the output (and in h0)
  __device__ float out(float v, float norm, int64_t at) const {
    if constexpr (kTeleport) return teleport(v, norm, h0[at]);
    else return __fmul_rn(v, norm);
  }
  __device__ float4 out4(float4 v, float norm, int64_t at) const {
    if constexpr (kTeleport) {
      const float4 h = *reinterpret_cast<const float4*>(h0 + at);
      return make_float4(teleport(v.x, norm, h.x), teleport(v.y, norm, h.y),
                         teleport(v.z, norm, h.z), teleport(v.w, norm, h.w));
    } else {
      return make_float4(__fmul_rn(v.x, norm), __fmul_rn(v.y, norm), __fmul_rn(v.z, norm),
                         __fmul_rn(v.w, norm));
    }
  }
};

// Lane l is column group l % lanes of edge group l / lanes; lanes past
// lanes * groups only take part in the shuffles. A warp owns one work item
// and one chunk of lanes * VEC columns (blockIdx.y; one chunk unless groups
// == 1 and f > 32 * VEC). Items 0 .. n_chunks - 1 are the hub chunks
// (chunks[item], an edge range of a split row, summed into part[item]),
// then item n_chunks + v is row v (summed into out, unless it has more than
// chunk_edges edges: its chunks sum it). HUB is false for a plan without
// chunks: item = row, and no row is left to chunks. H is the hop (NoHop,
// or APPNP's). Eight resident blocks
// per SM (64
// warps, at most 32 registers a thread): a row is a short chain of
// dependent reads, so the SM needs many rows in flight; ptxas meets that
// budget without spilling.
template <typename P, int VEC, bool HUB, typename H>
__global__ void __launch_bounds__(kWarps * 32, 8)
spmm_csr_kernel(const int32_t* __restrict__ indptr,
                const int32_t* __restrict__ indices,
                const typename P::TIn* __restrict__ x, const P p, const H h,
                float* __restrict__ out, const int2* __restrict__ chunks,
                typename P::TAcc* __restrict__ part, int n_rows, int n_chunks,
                int chunk_edges, int f, int lanes, int groups) {
  using TIn = typename P::TIn;
  using TAcc = typename P::TAcc;
  using V = typename VecOf<sizeof(TIn) * VEC>::T;
  using R = typename VecOf<sizeof(TIn) * VEC>::R;
  const int lane = threadIdx.x & 31;
  const int item = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (!HUB) n_chunks = 0;
  if (item >= n_chunks + n_rows) return;  // the whole warp leaves together
  int begin, end;
  if (HUB && item < n_chunks) {
    const int2 c = chunks[item];
    begin = c.x;
    end = c.y;
  } else {
    begin = indptr[item - n_chunks];
    end = indptr[item - n_chunks + 1];
    if (HUB && end - begin > chunk_edges) return;  // its chunks sum it
  }
  const int grp = lane / lanes;
  const int col = (blockIdx.y * lanes + lane - grp * lanes) * VEC;
  const bool active = grp < groups && col < f;
  const int head = active ? p.head(col) : 0;
  TAcc acc[VEC];
#pragma unroll
  for (int k = 0; k < VEC; ++k) acc[k] = 0;

  if constexpr (P::kWeighted) {
    // The window's kept edges, compacted (see the note at the top): one
    // weight per edge is read with its index, and only the edges whose
    // weight is not 0 are gathered; with several heads every edge is.
    const bool one = p.heads == 1;
    int kept = 0;
    // per warp, each kept edge's source and weight (or slot) at its rank
    __shared__ int s_src[kWarps][32];
    __shared__ int s_word[kWarps][32];
    const int wp = threadIdx.x >> 5;
    for (int e0 = begin; e0 < end; e0 += 32) {
      const int n = min(32, end - e0);
      const bool live = lane < n;
      const int mine = live ? indices[e0 + lane] : 0;
      const int slot = live ? p.slot(e0 + lane) : 0;
      // one head: the weight's bits; several: the slot, read in the step
      const int word = one ? (live ? __float_as_int(p.weight(slot, 0)) : 0) : slot;
      const unsigned keep = __ballot_sync(kFull, live && (!one || __int_as_float(word) != 0.f));
      const int m = __popc(keep);
      kept += m;
      if ((keep >> lane) & 1u) {
        const int r = __popc(keep & ((1u << lane) - 1u));
        s_src[wp][r] = mine;
        s_word[wp][r] = word;
      }
      __syncwarp();
      // two steps at a time: each group reads the rows (and norms) of its
      // kept edges r0 and r1 = r0 + G, then adds them in that order, so 2 G
      // independent row reads are in flight (j is warp-uniform)
      for (int j = 0; j < m; j += 2 * groups) {
        const int r0 = j + grp, r1 = r0 + groups;
        const bool a0 = active && r0 < m, a1 = active && r1 < m;
        R v0{}, v1{};
        float w0 = 0.f, w1 = 0.f, n0 = 0.f, n1 = 0.f;
        if (a0) {
          const int src = s_src[wp][r0], wd = s_word[wp][r0];
          w0 = one ? __int_as_float(wd) : p.weight(wd, head);
          if constexpr (H::kGather) n0 = h.gather(src);
          v0 = R(*reinterpret_cast<const V*>(x + static_cast<int64_t>(src) * f + col));
        }
        if (a1) {
          const int src = s_src[wp][r1], wd = s_word[wp][r1];
          w1 = one ? __int_as_float(wd) : p.weight(wd, head);
          if constexpr (H::kGather) n1 = h.gather(src);
          v1 = R(*reinterpret_cast<const V*>(x + static_cast<int64_t>(src) * f + col));
        }
        if (a0) {
#pragma unroll
          for (int c = 0; c < VEC; ++c) acc[c] += p.term(h.in(element<TIn>(v0, c), n0), w0);
        }
        if (a1) {
#pragma unroll
          for (int c = 0; c < VEC; ++c) acc[c] += p.term(h.in(element<TIn>(v1, c), n1), w1);
        }
      }
      __syncwarp();  // every lane has read the window before the next one is written
    }
    if (p.gathered != nullptr && lane == 0 && blockIdx.y == 0) p.gathered[item] += kept;
  } else {
    static_assert(!H::kGather, "only the weighted walks gather a norm");
    for (int e0 = begin; e0 < end; e0 += 32) {
      const int n = min(32, end - e0);
      const int mine = lane < n ? indices[e0 + lane] : 0;
      // one step: each group reads its own edge's row, so G independent
      // reads are in flight (j is warp-uniform)
      for (int j = 0; j < n; j += groups) {
        const int k = j + grp;  // this group's edge in the chunk
        const int src = __shfl_sync(kFull, mine, k & 31);
        if (active && k < n) {
          const R v = R(*reinterpret_cast<const V*>(x + static_cast<int64_t>(src) * f + col));
#pragma unroll
          for (int c = 0; c < VEC; ++c) acc[c] += p.term(h.in(element<TIn>(v, c), 0.f), 1.f);
        }
      }
    }
  }

  // fold the groups' partial sums onto group 0: groups [h, s) onto [0, s - h)
  for (int s = groups; s > 1;) {
    const int h = (s + 1) >> 1;
#pragma unroll
    for (int k = 0; k < VEC; ++k) {
      const TAcc o = __shfl_down_sync(kFull, acc[k], h * lanes);
      if (grp + h < s) acc[k] += o;
    }
    s = h;
  }
  if (!active || grp != 0) return;
  if (HUB && item < n_chunks) {  // a chunk's partial, as it is
    TAcc* o = part + static_cast<int64_t>(item) * f + col;
#pragma unroll
    for (int k = 0; k < VEC; ++k) o[k] = acc[k];
    return;
  }
  const int row = item - n_chunks;
  const int64_t at = static_cast<int64_t>(row) * f + col;
  float* o = out + at;  // zero-degree rows write zeros (or the hop's row of them)
  const float norm = h.row(row);
  if constexpr (VEC % 4 == 0) {
#pragma unroll
    for (int k = 0; k < VEC; k += 4)
      *reinterpret_cast<float4*>(o + k) = h.out4(
          make_float4(p.out(acc[k], col + k), p.out(acc[k + 1], col + k + 1),
                      p.out(acc[k + 2], col + k + 2), p.out(acc[k + 3], col + k + 3)),
          norm, at + k);
  } else {
#pragma unroll
    for (int k = 0; k < VEC; ++k) o[k] = h.out(p.out(acc[k], col + k), norm, at + k);
  }
}

// One warp per split row s: out[rows[s]] = the sum of part[first[s]] ...
// part[first[s + 1] - 1] in chunk order, written as the walk writes a row
// (the int8 policy scales the exact int32 sum once, here; the hop's
// epilogue follows).
template <typename P, typename H>
__global__ void __launch_bounds__(kWarps * 32)
spmm_csr_combine_kernel(const int32_t* __restrict__ rows, const int32_t* __restrict__ first,
                        const typename P::TAcc* __restrict__ part, const P p, const H h,
                        float* __restrict__ out, int n_split, int f) {
  using TAcc = typename P::TAcc;
  const int lane = threadIdx.x & 31;
  const int s = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (s >= n_split) return;
  const int k0 = first[s], k1 = first[s + 1];
  const int row = rows[s];
  const int64_t at = static_cast<int64_t>(row) * f;
  float* o = out + at;
  const float norm = h.row(row);
  for (int col = lane; col < f; col += 32) {
    TAcc acc = 0;
#pragma unroll 4
    for (int k = k0; k < k1; ++k) acc += part[static_cast<int64_t>(k) * f + col];
    o[col] = h.out(p.out(acc, col), norm, at + col);
  }
}

template <typename P, typename H, int VEC>
void launch_vec(const int32_t* indptr, const int32_t* indices, const typename P::TIn* x,
                const P& p, const H& h, float* out, const int2* chunks,
                typename P::TAcc* part, int n_rows, int n_chunks, int chunk_edges, int f,
                int lanes, int groups, cudaStream_t stream) {
  const dim3 grid((n_chunks + n_rows + kWarps - 1) / kWarps,
                  (f + lanes * VEC - 1) / (lanes * VEC));
  const dim3 block(kWarps * 32);
  if (n_chunks > 0)
    spmm_csr_kernel<P, VEC, true, H><<<grid, block, 0, stream>>>(
        indptr, indices, x, p, h, out, chunks, part, n_rows, n_chunks, chunk_edges, f, lanes,
        groups);
  else
    spmm_csr_kernel<P, VEC, false, H><<<grid, block, 0, stream>>>(
        indptr, indices, x, p, h, out, chunks, part, n_rows, 0, chunk_edges, f, lanes,
        groups);
}

// Checks the caller's geometry and launches the instantiation for its VEC. A
// geometry is taken when VEC is a power of two of at most 8 elements and 16
// bytes that divides F and suits the policy, x and out are aligned for it,
// the groups fit in a warp, and several groups share a row only when one
// chunk covers it; a plan, when it has chunks, comes with its partials and a
// chunk length of at least one edge; a hop's h0, when it has one, is
// aligned as out.
template <typename P, typename H = NoHop>
int launch(const int32_t* indptr, const int32_t* indices, const typename P::TIn* x,
           const P& p, float* out, const void* chunks, void* part, int n_rows, int n_chunks,
           int chunk_edges, int f, int vec, int lanes, int groups, cudaStream_t stream,
           const H& h = H{}, const void* h0 = nullptr) {
  if (n_rows < 0 || n_chunks < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (n_rows + n_chunks == 0 || f <= 0) return static_cast<int>(cudaGetLastError());
  using TIn = typename P::TIn;
  using TAcc = typename P::TAcc;
  constexpr int kMaxVec = sizeof(TIn) >= 2 ? 16 / static_cast<int>(sizeof(TIn)) : 8;
  const uintptr_t x_addr = reinterpret_cast<uintptr_t>(x);
  const uintptr_t out_addr = reinterpret_cast<uintptr_t>(out);
  const bool ok = vec >= 1 && vec <= kMaxVec && (vec & (vec - 1)) == 0 && f % vec == 0 &&
                  p.fits(vec) && h.fits(vec, reinterpret_cast<uintptr_t>(h0)) &&
                  x_addr % (vec * sizeof(TIn)) == 0 &&
                  (vec % 4 != 0 || out_addr % 16 == 0) && lanes >= 1 && lanes <= 32 &&
                  groups >= 1 && lanes * groups <= 32 && (groups == 1 || lanes * vec >= f) &&
                  chunk_edges >= 1 &&
                  (n_chunks == 0 || (chunks != nullptr && part != nullptr));
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  const auto* ch = static_cast<const int2*>(chunks);
  auto* pt = static_cast<TAcc*>(part);
  switch (vec) {
    case 8:
      if constexpr (kMaxVec >= 8)
        launch_vec<P, H, 8>(indptr, indices, x, p, h, out, ch, pt, n_rows, n_chunks,
                             chunk_edges, f, lanes, groups, stream);
      break;
    case 4:
      launch_vec<P, H, 4>(indptr, indices, x, p, h, out, ch, pt, n_rows, n_chunks,
                           chunk_edges, f, lanes, groups, stream);
      break;
    case 2:
      launch_vec<P, H, 2>(indptr, indices, x, p, h, out, ch, pt, n_rows, n_chunks,
                           chunk_edges, f, lanes, groups, stream);
      break;
    default:
      launch_vec<P, H, 1>(indptr, indices, x, p, h, out, ch, pt, n_rows, n_chunks,
                           chunk_edges, f, lanes, groups, stream);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename P, typename H = NoHop>
int combine(const void* rows, const void* first, const void* part, const P& p, void* out,
            int n_split, int f, void* stream, const H& h = H{}) {
  if (n_split < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (n_split == 0 || f <= 0) return static_cast<int>(cudaGetLastError());
  spmm_csr_combine_kernel<P, H><<<(n_split + kWarps - 1) / kWarps, kWarps * 32, 0,
                                  static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(rows), static_cast<const int32_t*>(first),
      static_cast<const typename P::TAcc*>(part), p, h, static_cast<float*>(out), n_split, f);
  return static_cast<int>(cudaGetLastError());
}

Weighted weighted_policy(const void* widx, const void* w, int f, int heads,
                         void* gathered = nullptr) {
  return Weighted{static_cast<const int32_t*>(widx), static_cast<const float*>(w), heads,
                  heads > 0 ? f / heads : 0, static_cast<int32_t*>(gathered)};
}

template <int PASS>
Appnp<PASS> appnp_hop(const void* gather_norm, const void* row_norm, const void* h0, float c1,
                      float c2) {
  return Appnp<PASS>{static_cast<const float*>(gather_norm), static_cast<const float*>(row_norm),
                     static_cast<const float*>(h0), c1, c2};
}

}  // namespace

extern "C" {

// The walks. Every entry point takes the hub plan of its CSR: chunks int32
// [n_chunks, 2] (each chunk's edge range), part [n_chunks, f] the chunks'
// partials (f32; int32 for int8), both null when n_chunks is 0, and
// chunk_edges the T the plan was cut with; (vec, lanes, groups) as
// ops/spmm_cuda.py `geometry` gives them.

// exact tier: x bf16 [*, f], out f32 [n_rows, f]
int spmm_csr_bf16(const void* indptr, const void* indices, const void* x, void* out,
                  const void* chunks, void* part, int n_rows, int n_chunks, int chunk_edges,
                  int f, int vec, int lanes, int groups, void* stream) {
  return launch(static_cast<const int32_t*>(indptr), static_cast<const int32_t*>(indices),
                static_cast<const __nv_bfloat16*>(x), Sum<__nv_bfloat16, float>{nullptr},
                static_cast<float*>(out), chunks, part, n_rows, n_chunks, chunk_edges, f, vec,
                lanes, groups, static_cast<cudaStream_t>(stream));
}

// int8 tier: x int8 [*, f], scale f32 [f], out f32 [n_rows, f]
int spmm_csr_int8(const void* indptr, const void* indices, const void* x, const void* scale,
                  void* out, const void* chunks, void* part, int n_rows, int n_chunks,
                  int chunk_edges, int f, int vec, int lanes, int groups, void* stream) {
  return launch(static_cast<const int32_t*>(indptr), static_cast<const int32_t*>(indices),
                static_cast<const int8_t*>(x), Sum<int8_t, int>{static_cast<const float*>(scale)},
                static_cast<float*>(out), chunks, part, n_rows, n_chunks, chunk_edges, f, vec,
                lanes, groups, static_cast<cudaStream_t>(stream));
}

// weighted: x f32 [*, f], w f32 [E, heads] (heads divides f), widx int32
// (weight index of each CSR slot) or null for the slot itself, gathered
// int32 [n_chunks + n_rows] (each work item's gathered edges are added to
// it) or null, out f32 [n_rows, f]
int spmm_csr_weighted(const void* indptr, const void* indices, const void* widx, const void* x,
                      const void* w, void* gathered, void* out, const void* chunks, void* part,
                      int n_rows, int n_chunks, int chunk_edges, int f, int heads, int vec,
                      int lanes, int groups, void* stream) {
  if (heads <= 0 || f % heads != 0) return static_cast<int>(cudaErrorInvalidValue);
  return launch(static_cast<const int32_t*>(indptr), static_cast<const int32_t*>(indices),
                static_cast<const float*>(x), weighted_policy(widx, w, f, heads, gathered),
                static_cast<float*>(out), chunks, part, n_rows, n_chunks, chunk_edges, f, vec,
                lanes, groups, static_cast<cudaStream_t>(stream));
}

// APPNP's hops (the note at the top): x, w, widx and the plan as the walk
// of their policy takes them (weighted: one weight per edge); gather_norm
// f32 [*] the gathered rows' norm (forward: src_norm; transposed:
// dst_norm), row_norm f32 [n_rows] the written rows' (forward and eval:
// dst_norm; transposed: src_norm), h0 f32 [n_rows, f] (null on the
// transposed walk), gathered as the weighted walk takes it, c1 = float(1 -
// alpha), c2 = float(alpha).

int spmm_csr_weighted_hop(const void* indptr, const void* indices, const void* widx,
                          const void* x, const void* w, const void* gather_norm,
                          const void* row_norm, const void* h0, void* gathered, void* out,
                          const void* chunks, void* part, int n_rows, int n_chunks,
                          int chunk_edges, int f, int transposed, float c1, float c2, int vec,
                          int lanes, int groups, void* stream) {
  const auto* ip = static_cast<const int32_t*>(indptr);
  const auto* ix = static_cast<const int32_t*>(indices);
  const auto* xf = static_cast<const float*>(x);
  const Weighted p = weighted_policy(widx, w, f, 1, gathered);
  auto* o = static_cast<float*>(out);
  const auto st = static_cast<cudaStream_t>(stream);
  if (transposed)
    return launch(ip, ix, xf, p, o, chunks, part, n_rows, n_chunks, chunk_edges, f, vec, lanes,
                  groups, st, appnp_hop<kHopTransposed>(gather_norm, row_norm, nullptr, c1, c2));
  return launch(ip, ix, xf, p, o, chunks, part, n_rows, n_chunks, chunk_edges, f, vec, lanes,
                groups, st, appnp_hop<kHopForward>(gather_norm, row_norm, h0, c1, c2), h0);
}

int spmm_csr_int8_hop(const void* indptr, const void* indices, const void* x, const void* scale,
                      const void* row_norm, const void* h0, void* out, const void* chunks,
                      void* part, int n_rows, int n_chunks, int chunk_edges, int f, float c1,
                      float c2, int vec, int lanes, int groups, void* stream) {
  return launch(static_cast<const int32_t*>(indptr), static_cast<const int32_t*>(indices),
                static_cast<const int8_t*>(x), Sum<int8_t, int>{static_cast<const float*>(scale)},
                static_cast<float*>(out), chunks, part, n_rows, n_chunks, chunk_edges, f, vec,
                lanes, groups, static_cast<cudaStream_t>(stream),
                appnp_hop<kHopEval>(nullptr, row_norm, h0, c1, c2), h0);
}

// The sums of the split rows: rows int32 [n_split] (the plan's split rows),
// first int32 [n_split + 1] (row s's partials are part[first[s]:first[s +
// 1]]), part as the walk wrote it, out f32 [*, f] as the walk's.

int spmm_csr_bf16_combine(const void* rows, const void* first, const void* part, void* out,
                          int n_split, int f, void* stream) {
  return combine(rows, first, part, Sum<__nv_bfloat16, float>{nullptr}, out, n_split, f,
                 stream);
}

int spmm_csr_int8_combine(const void* rows, const void* first, const void* part,
                          const void* scale, void* out, int n_split, int f, void* stream) {
  return combine(rows, first, part, Sum<int8_t, int>{static_cast<const float*>(scale)}, out,
                 n_split, f, stream);
}

int spmm_csr_weighted_combine(const void* rows, const void* first, const void* part, void* out,
                              int n_split, int f, void* stream) {
  return combine(rows, first, part, weighted_policy(nullptr, nullptr, f, 1), out, n_split, f,
                 stream);
}

// the hops' sums of the split rows: row_norm, h0, c1 and c2 as their walk's
int spmm_csr_weighted_hop_combine(const void* rows, const void* first, const void* part,
                                  const void* row_norm, const void* h0, void* out, int n_split,
                                  int f, int transposed, float c1, float c2, void* stream) {
  const Weighted p = weighted_policy(nullptr, nullptr, f, 1);
  if (transposed)
    return combine(rows, first, part, p, out, n_split, f, stream,
                   appnp_hop<kHopTransposed>(nullptr, row_norm, nullptr, c1, c2));
  return combine(rows, first, part, p, out, n_split, f, stream,
                 appnp_hop<kHopForward>(nullptr, row_norm, h0, c1, c2));
}

int spmm_csr_int8_hop_combine(const void* rows, const void* first, const void* part,
                              const void* scale, const void* row_norm, const void* h0, void* out,
                              int n_split, int f, float c1, float c2, void* stream) {
  return combine(rows, first, part, Sum<int8_t, int>{static_cast<const float*>(scale)}, out,
                 n_split, f, stream, appnp_hop<kHopEval>(nullptr, row_norm, h0, c1, c2));
}

}  // extern "C"
