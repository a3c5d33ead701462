// CSR gather-reduce SpMM for Hopper (sm_90a): out[v] = sum_{e in row v} x[idx[e]].
//
// Replaces the TPU kernels glnn_tpu/ops/spmm_pallas.py:_block_kernel (:93)
// and :_kernel (:59). Those build a one-hot [d, X] matrix per dst block and
// reduce pre-gathered message rows on the MXU, because the TPU has no fast
// scatter and no fast in-core row gather. Hopper has both a fast random row
// read (L2-backed) and a register file per thread, so the gather and the
// reduction are fused here: the edges are dst-sorted, each dst row is owned by
// exactly one warp, and the warp walks indptr[v]:indptr[v+1] reading x rows
// and summing in registers. No one-hot, no atomics, no message tensor in
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
//     F = 64 bf16: VEC 8, G = 4);
//   - 64 warps per SM (the register budget is 32), so that many rows are in
//     flight at once, and few instructions per step: no division in the
//     loop, no loop over column chunks, and an int8 element is sign-extended
//     by two shifts, the second fused into its add (issuing two steps' reads
//     before summing either gained nothing at these widths and spilled the
//     weighted policy);
//   - each group keeps its own partial sum, and the groups' partials merge
//     with __shfl_down_sync at the row's end, so a row takes one pass over its
//     edges at every width up to 32 * VEC; wider rows (G = 1) are split into
//     chunks of 32 * VEC columns, one warp each (the grid's y);
//   - the warp loads 32 indices with one coalesced read and hands them out
//     with __shfl_sync.
// Still one warp per row, with no atomics and a fixed order of summation for a
// given geometry: a hub row is only slower (its warp walks it alone).
//
// The geometry (VEC, L, G) is worked out by the caller (ops/spmm_cuda.py
// `geometry`) and checked here: an entry point returns cudaErrorInvalidValue
// for a geometry that it does not instantiate or that would misalign a row.
//
// Three instantiations of one kernel body, told apart by a policy type that
// says what a gathered element adds to the sum and how the sum is written:
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
// Interface: plain C, called through ctypes. Every entry point launches on
// the given stream, never synchronises, allocates nothing, and returns
// cudaGetLastError() so that a refused launch is reported to the caller.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

namespace {

constexpr int kWarps = 8;   // dst rows per block, one warp per row
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

  bool fits(int vec) const { return d % vec == 0; }  // a lane's columns share a head
  __device__ int head(int col) const { return col / d; }
  __device__ int slot(int e) const { return widx != nullptr ? widx[e] : e; }
  __device__ float weight(int slot, int head) const {
    return w[static_cast<int64_t>(slot) * heads + head];
  }
  __device__ float term(float v, float wv) const { return round_bf16(v * wv); }
  __device__ float out(float acc, int) const { return acc; }
};

// Lane l is column group l % lanes of edge group l / lanes; lanes past
// lanes * groups only take part in the shuffles. A warp owns one row and one
// chunk of lanes * VEC columns (blockIdx.y; one chunk unless groups == 1 and
// f > 32 * VEC). Eight resident blocks per SM (64 warps, at most 32 registers
// a thread): a row is a short chain of dependent reads, so the SM needs many
// rows in flight; ptxas meets that budget without spilling.
template <typename P, int VEC>
__global__ void __launch_bounds__(kWarps * 32, 8)
spmm_csr_kernel(const int32_t* __restrict__ indptr,
                const int32_t* __restrict__ indices,
                const typename P::TIn* __restrict__ x, const P p,
                float* __restrict__ out, int n_rows, int f, int lanes, int groups) {
  using TIn = typename P::TIn;
  using TAcc = typename P::TAcc;
  using V = typename VecOf<sizeof(TIn) * VEC>::T;
  using R = typename VecOf<sizeof(TIn) * VEC>::R;
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (row >= n_rows) return;  // the whole warp leaves together
  const int grp = lane / lanes;
  const int col = (blockIdx.y * lanes + lane - grp * lanes) * VEC;
  const bool active = grp < groups && col < f;
  const int head = active ? p.head(col) : 0;
  TAcc acc[VEC];
#pragma unroll
  for (int k = 0; k < VEC; ++k) acc[k] = 0;

  const int end = indptr[row + 1];
  for (int e0 = indptr[row]; e0 < end; e0 += 32) {
    const int n = min(32, end - e0);
    const int mine = lane < n ? indices[e0 + lane] : 0;
    int my_slot = 0;
    if constexpr (P::kWeighted) my_slot = lane < n ? p.slot(e0 + lane) : 0;
    // one step: each group reads its own edge's row, so G independent reads
    // are in flight (j is warp-uniform)
    for (int j = 0; j < n; j += groups) {
      const int k = j + grp;  // this group's edge in the chunk
      const int src = __shfl_sync(kFull, mine, k & 31);
      int slot = 0;
      if constexpr (P::kWeighted) slot = __shfl_sync(kFull, my_slot, k & 31);
      if (active && k < n) {
        const float wv = p.weight(slot, head);
        const R v = R(*reinterpret_cast<const V*>(x + static_cast<int64_t>(src) * f + col));
#pragma unroll
        for (int c = 0; c < VEC; ++c) acc[c] += p.term(element<TIn>(v, c), wv);
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
  if (active && grp == 0) {  // zero-degree rows write zeros
    float* o = out + static_cast<int64_t>(row) * f + col;
    if constexpr (VEC % 4 == 0) {
#pragma unroll
      for (int k = 0; k < VEC; k += 4)
        *reinterpret_cast<float4*>(o + k) =
            make_float4(p.out(acc[k], col + k), p.out(acc[k + 1], col + k + 1),
                        p.out(acc[k + 2], col + k + 2), p.out(acc[k + 3], col + k + 3));
    } else {
#pragma unroll
      for (int k = 0; k < VEC; ++k) o[k] = p.out(acc[k], col + k);
    }
  }
}

template <typename P, int VEC>
void launch_vec(const int32_t* indptr, const int32_t* indices, const typename P::TIn* x,
                const P& p, float* out, int n_rows, int f, int lanes, int groups,
                cudaStream_t stream) {
  const dim3 grid((n_rows + kWarps - 1) / kWarps, (f + lanes * VEC - 1) / (lanes * VEC));
  const dim3 block(kWarps * 32);
  spmm_csr_kernel<P, VEC><<<grid, block, 0, stream>>>(indptr, indices, x, p, out, n_rows, f,
                                                       lanes, groups);
}

// Checks the caller's geometry and launches the instantiation for its VEC. A
// geometry is taken when VEC is a power of two of at most 8 elements and 16
// bytes that divides F and suits the policy, x and out are aligned for it,
// the groups fit in a warp, and several groups share a row only when one
// chunk covers it.
template <typename P>
int launch(const int32_t* indptr, const int32_t* indices, const typename P::TIn* x,
           const P& p, float* out, int n_rows, int f, int vec, int lanes, int groups,
           cudaStream_t stream) {
  if (n_rows <= 0 || f <= 0) return static_cast<int>(cudaGetLastError());
  using TIn = typename P::TIn;
  constexpr int kMaxVec = sizeof(TIn) >= 2 ? 16 / static_cast<int>(sizeof(TIn)) : 8;
  const uintptr_t x_addr = reinterpret_cast<uintptr_t>(x);
  const uintptr_t out_addr = reinterpret_cast<uintptr_t>(out);
  const bool ok = vec >= 1 && vec <= kMaxVec && (vec & (vec - 1)) == 0 && f % vec == 0 &&
                  p.fits(vec) && x_addr % (vec * sizeof(TIn)) == 0 &&
                  (vec % 4 != 0 || out_addr % 16 == 0) && lanes >= 1 && lanes <= 32 &&
                  groups >= 1 && lanes * groups <= 32 && (groups == 1 || lanes * vec >= f);
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  switch (vec) {
    case 8:
      if constexpr (kMaxVec >= 8)
        launch_vec<P, 8>(indptr, indices, x, p, out, n_rows, f, lanes, groups, stream);
      break;
    case 4:
      launch_vec<P, 4>(indptr, indices, x, p, out, n_rows, f, lanes, groups, stream);
      break;
    case 2:
      launch_vec<P, 2>(indptr, indices, x, p, out, n_rows, f, lanes, groups, stream);
      break;
    default:
      launch_vec<P, 1>(indptr, indices, x, p, out, n_rows, f, lanes, groups, stream);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// exact tier: x bf16 [*, f], out f32 [n_rows, f]; (vec, lanes, groups) as
// ops/spmm_cuda.py `geometry` gives them
int spmm_csr_bf16(const void* indptr, const void* indices, const void* x, void* out,
                  int n_rows, int f, int vec, int lanes, int groups, void* stream) {
  return launch(static_cast<const int32_t*>(indptr), static_cast<const int32_t*>(indices),
                static_cast<const __nv_bfloat16*>(x), Sum<__nv_bfloat16, float>{nullptr},
                static_cast<float*>(out), n_rows, f, vec, lanes, groups,
                static_cast<cudaStream_t>(stream));
}

// int8 tier: x int8 [*, f], scale f32 [f], out f32 [n_rows, f]
int spmm_csr_int8(const void* indptr, const void* indices, const void* x, const void* scale,
                  void* out, int n_rows, int f, int vec, int lanes, int groups, void* stream) {
  return launch(static_cast<const int32_t*>(indptr), static_cast<const int32_t*>(indices),
                static_cast<const int8_t*>(x), Sum<int8_t, int>{static_cast<const float*>(scale)},
                static_cast<float*>(out), n_rows, f, vec, lanes, groups,
                static_cast<cudaStream_t>(stream));
}

// weighted: x f32 [*, f], w f32 [E, heads] (heads divides f), widx int32
// (weight index of each CSR slot) or null for the slot itself, out f32
// [n_rows, f]
int spmm_csr_weighted(const void* indptr, const void* indices, const void* widx, const void* x,
                      const void* w, void* out, int n_rows, int f, int heads, int vec,
                      int lanes, int groups, void* stream) {
  if (heads <= 0 || f % heads != 0) return static_cast<int>(cudaErrorInvalidValue);
  const Weighted p{static_cast<const int32_t*>(widx), static_cast<const float*>(w), heads,
                   f / heads};
  return launch(static_cast<const int32_t*>(indptr), static_cast<const int32_t*>(indices),
                static_cast<const float*>(x), p, static_cast<float*>(out), n_rows, f, vec,
                lanes, groups, static_cast<cudaStream_t>(stream));
}

}  // extern "C"
