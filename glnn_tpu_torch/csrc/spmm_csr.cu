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
// (E * F adds) is far below the card's rate. The design therefore keeps the
// reads wide and coalesced: a lane loads VEC contiguous features (up to 16
// bytes) of a row, the 32 lanes of a warp cover one row's feature span, and
// the warp fetches 32 indices with one coalesced load and broadcasts them
// with __shfl_sync.
//
// Three instantiations of one kernel body, told apart by a policy type that
// says what a gathered element adds to the sum and how the sum is written:
//   exact:    bf16 rows, f32 accumulation, f32 output;
//   int8:     int8 rows, int32 accumulation (exact), output acc * scale[f] in
//             f32 (the per-column dequantisation of spmm_pallas.py:408-414);
//   weighted: the counterpart of the same TPU kernels under
//             spmm_pallas.u_mul_e_sum (:438, messages built at :288-310):
//             out[v] = sum_{e in row v} bf16(x[idx[e]] * w[widx(e)]) in f32.
//             x is f32 [*, H*D]; w is f32 [E, H] (H = 1: one scalar per
//             edge), and lane column c takes the weight of head c / D. As
//             JAX does, the product is formed in f32 and rounded once to
//             bf16 before the sum. widx(e) is e on the forward walk (the
//             weights are in dst-sorted edge order); on the transposed walk
//             (t_indptr, t_receivers) the caller passes t_edges, and the
//             kernel reads the dst-ordered weights through it, so no
//             permuted copy of w and no [E, F] message tensor exist. Its
//             bound is bytes as for the others (the gathered x rows, plus
//             the weights and the weight indices); its VEC also divides D,
//             so that a lane's columns share one head.
// All three share the lane layout, so F = 40 gets VEC = 1 and a second,
// mostly idle pass over columns 32-39 (a later mapping fix, ROADMAP B.5).
//
// Interface: plain C, called through ctypes. Every entry point launches on
// the given stream, never synchronises, allocates nothing, and returns
// cudaGetLastError() so that a refused launch is reported to the caller.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kWarps = 8;  // dst rows per block, one warp per row

template <int BYTES> struct VecOf;
template <> struct VecOf<16> { using T = uint4; };
template <> struct VecOf<8> { using T = uint2; };
template <> struct VecOf<4> { using T = unsigned int; };
template <> struct VecOf<2> { using T = unsigned short; };
template <> struct VecOf<1> { using T = unsigned char; };

__device__ __forceinline__ float widen(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ int widen(int8_t v) { return static_cast<int>(v); }

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
  __device__ TAcc term(TIn v, float) const { return widen(v); }
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

template <typename P, int VEC>
__global__ void __launch_bounds__(kWarps * 32)
spmm_csr_kernel(const int32_t* __restrict__ indptr,
                const int32_t* __restrict__ indices,
                const typename P::TIn* __restrict__ x, const P p,
                float* __restrict__ out, int n_rows, int f) {
  using TIn = typename P::TIn;
  using V = typename VecOf<sizeof(TIn) * VEC>::T;
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (row >= n_rows) return;  // the whole warp leaves together
  const int start = indptr[row];
  const int end = indptr[row + 1];

  // warp-uniform loop over 32*VEC-wide feature chunks (one chunk for the
  // widths of the main path); lanes past F only take part in the shuffles
  for (int c0 = 0; c0 < f; c0 += 32 * VEC) {
    const int col = c0 + lane * VEC;
    const bool active = col < f;
    const int head = active ? p.head(col) : 0;
    typename P::TAcc acc[VEC];
#pragma unroll
    for (int k = 0; k < VEC; ++k) acc[k] = 0;

    for (int e0 = start; e0 < end; e0 += 32) {
      const int n = min(32, end - e0);
      const int mine = lane < n ? indices[e0 + lane] : 0;
      int my_slot = 0;
      if constexpr (P::kWeighted) my_slot = lane < n ? p.slot(e0 + lane) : 0;
#pragma unroll 4
      for (int j = 0; j < n; ++j) {
        const int src = __shfl_sync(0xffffffffu, mine, j);
        int slot = 0;
        if constexpr (P::kWeighted) slot = __shfl_sync(0xffffffffu, my_slot, j);
        if (active) {
          const float wv = p.weight(slot, head);
          const V v = *reinterpret_cast<const V*>(x + static_cast<int64_t>(src) * f + col);
          const TIn* el = reinterpret_cast<const TIn*>(&v);
#pragma unroll
          for (int k = 0; k < VEC; ++k) acc[k] += p.term(el[k], wv);
        }
      }
    }
    if (active) {  // zero-degree rows write zeros
      float* o = out + static_cast<int64_t>(row) * f + col;
#pragma unroll
      for (int k = 0; k < VEC; ++k) o[k] = p.out(acc[k], col + k);
    }
  }
}

template <typename P, int VEC>
void launch_vec(const int32_t* indptr, const int32_t* indices, const typename P::TIn* x,
                const P& p, float* out, int n_rows, int f, cudaStream_t stream) {
  const dim3 grid((n_rows + kWarps - 1) / kWarps);
  const dim3 block(kWarps * 32);
  spmm_csr_kernel<P, VEC><<<grid, block, 0, stream>>>(indptr, indices, x, p, out, n_rows, f);
}

// VEC: the widest load (at most 16 bytes) that divides F, suits the policy,
// keeps every row aligned, and still gives each of the 32 lanes work; 1
// otherwise.
template <typename P>
int launch(const int32_t* indptr, const int32_t* indices, const typename P::TIn* x,
           const P& p, float* out, int n_rows, int f, cudaStream_t stream) {
  if (n_rows <= 0 || f <= 0) return static_cast<int>(cudaGetLastError());
  using TIn = typename P::TIn;
  constexpr int kMaxVec = 16 / static_cast<int>(sizeof(TIn));
  const uintptr_t base = reinterpret_cast<uintptr_t>(x);
  int vec = 1;
  for (int v = kMaxVec; v >= 2; v /= 2) {
    if (f % v == 0 && p.fits(v) && f >= 32 * v && base % (v * sizeof(TIn)) == 0) {
      vec = v;
      break;
    }
  }
  switch (vec) {
    case 16:
      if constexpr (kMaxVec >= 16) launch_vec<P, 16>(indptr, indices, x, p, out, n_rows, f, stream);
      break;
    case 8:
      if constexpr (kMaxVec >= 8) launch_vec<P, 8>(indptr, indices, x, p, out, n_rows, f, stream);
      break;
    case 4:
      launch_vec<P, 4>(indptr, indices, x, p, out, n_rows, f, stream);
      break;
    case 2:
      launch_vec<P, 2>(indptr, indices, x, p, out, n_rows, f, stream);
      break;
    default:
      launch_vec<P, 1>(indptr, indices, x, p, out, n_rows, f, stream);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// exact tier: x bf16 [*, f], out f32 [n_rows, f]
int spmm_csr_bf16(const void* indptr, const void* indices, const void* x, void* out,
                  int n_rows, int f, void* stream) {
  return launch(static_cast<const int32_t*>(indptr), static_cast<const int32_t*>(indices),
                static_cast<const __nv_bfloat16*>(x), Sum<__nv_bfloat16, float>{nullptr},
                static_cast<float*>(out), n_rows, f, static_cast<cudaStream_t>(stream));
}

// int8 tier: x int8 [*, f], scale f32 [f], out f32 [n_rows, f]
int spmm_csr_int8(const void* indptr, const void* indices, const void* x, const void* scale,
                  void* out, int n_rows, int f, void* stream) {
  return launch(static_cast<const int32_t*>(indptr), static_cast<const int32_t*>(indices),
                static_cast<const int8_t*>(x), Sum<int8_t, int>{static_cast<const float*>(scale)},
                static_cast<float*>(out), n_rows, f, static_cast<cudaStream_t>(stream));
}

// weighted: x f32 [*, f], w f32 [E, heads] (heads divides f), widx int32
// (weight index of each CSR slot) or null for the slot itself, out f32
// [n_rows, f]
int spmm_csr_weighted(const void* indptr, const void* indices, const void* widx, const void* x,
                      const void* w, void* out, int n_rows, int f, int heads, void* stream) {
  if (heads <= 0 || f % heads != 0) return static_cast<int>(cudaErrorInvalidValue);
  const Weighted p{static_cast<const int32_t*>(widx), static_cast<const float*>(w), heads,
                   f / heads};
  return launch(static_cast<const int32_t*>(indptr), static_cast<const int32_t*>(indices),
                static_cast<const float*>(x), p, static_cast<float*>(out), n_rows, f,
                static_cast<cudaStream_t>(stream));
}

}  // extern "C"
