// GAT attention for Hopper (sm_90a) on the CSC: the fused attention forward
// and backward, and the standalone segment softmax and its backward.
//
// Replaces glnn_tpu/ops/gat_pallas.py:_gat_fwd_kernel (:158) and
// :_gat_bwd_kernel (:187). Those run in AttentionPlan slot space: per dst
// block they form the scores with a block-diagonal attn_l matmul, pick er per
// slot with a one-hot matmul, subtract the block's score max, and broadcast
// per-head weights over features with a replication matrix, all because the
// TPU's only fast reduction is the MXU. None of that carries over. Here the
// edges are dst-sorted, one warp owns a dst row v and walks its in-edges
// indptr[v]:indptr[v+1]; the per-node scalars el and er, both computed
// outside (er as gat_pallas.py:409-420 computes it outside its kernel; el
// once per node, where the TPU kernel computes it per slot in its body,
// gat_pallas.py:107-118), make each score
// s = leaky_relu(el[src,h] + er[v,h]) a two-load affair, and the softmax, the
// dropout and the weighted sum are kept in registers.
//
// Forward (gat_fwd). Lane layout: D = per-head width, H = heads. A lane
// holds VEC consecutive features (VEC the largest power of two <= 8 dividing
// D: one load of up to 16 bytes), REPS such groups strided by LANES * VEC,
// all in one head. LANES (a power of two <= 32) lanes cover a head, 32 / LANES
// heads share a pass over the row's edges, and ceil(H / (32 / LANES)) passes
// cover all heads ((8, 16): VEC 8, LANES 2; (1, 40): VEC 8, LANES 8). Per dst
// row and head, an online softmax: the running segment max m and denominator
// den (of the UNDROPPED weights, dgl GATConv semantics) are rescaled when m
// rises, and the dropped weights p * keep / keep_prob scale the bf16 source
// rows into an f32 accumulator. out = acc / den in f32. The segment's own max
// is subtracted, so no segment underflows, unlike the TPU kernel's block max
// (gat_pallas.py:35-42). A row with no in-edges writes zeros (and max 0,
// den 0). The per-dst max and den [N, H] are written for the backward.
//
// Backward (gat_bwd). Per dst row v and head h, with alpha_e = exp(s_e - max)
// / den from the forward's saved max and den, w_e the dropout weight and
// g_e = <feat[src,h,:], dout[v,h,:]>, pass 1 sums t = sum_e alpha_e w_e g_e;
// pass 2 forms the softmax VJP ds = alpha (w g - t), ds_pre = ds through
// leaky_relu' (the s_pre >= 0 branch, as the JAX kernel), and writes
//   der[v,h]        = sum_e ds_pre                        (f32)
//   msg[e,h*D+j]    = alpha w dout[v,h,j] + ds_pre attn_l[h,j]   (bf16)
//   dal_part[warp]  += ds_pre feat[src,h,:]               (f32, per warp)
// The whole chain is f32: bf16 there gave ~10% gradient error
// (gat_pallas.py:237-239). Warps stride over rows and each keeps its own
// dattn_l partial, which the caller sums: no atomics, a deterministic result.
// The message, in dst-sorted edge order, is reduced over sources by the CSR
// SpMM kernel (spmm_csr.cu) over the transposed CSR, as _fused_bwd does with
// segment_reduce (gat_pallas.py:494). der and dattn_l could be written as
// differences of row sums (sum c w g - t sum c, c = alpha leaky_relu'), which
// would spare pass 2 the feature reads; where the attention is concentrated
// and dout is large those differences cancel more than the per-edge sum
// does (more than tenfold in tests/test_torch_kernel_design.py), so ds_pre
// stays per edge.
//
// Bound on an H100: bytes. Per call the forward must read the bf16 features
// once (most of the E gathers hit the 50 MB L2 at ogbn-arxiv scale), el, er,
// the indices and the [E, H] keep mask, and write out, max and den; its
// arithmetic (about 2 E H D flops plus E H exponentials) is far below the
// card's rate. The backward's largest term is its [E, H*D] bf16 message write
// (about 650 MB at E = 2.5M, H*D = 128); what holds it back is the latency of
// each edge's chain (index, el[src] and feature-row loads, exp, the per-head
// dot product). Its design:
//   - lanes lie across (edge slot, head, column group): LH = ceil(D / VEC /
//     REPS) lanes cover a head (not a power of two: (1, 40) gives 5), HP heads
//     an edge, and SLOTS = 32 / (HP * LH) edges are walked at once ((8, 16):
//     16 lanes per edge, 2 slots; (1, 40): 5 lanes per edge, 6 slots); g_e
//     reduces over the head's LH lanes with __shfl_down_sync;
//   - pass 1 forms alpha, w and g per edge and sums t, and keeps (alpha, w,
//     w g, the leaky_relu' factor) of the row's first K edges in shared memory
//     (K = 4 KB per warp / (16 bytes * HP));
//   - pass 2 takes those terms from the cache and reads the edge's feature
//     slice again for dattn_l (the row was just gathered by the same warp),
//     and attn_l from L1, so that neither is held in registers across the
//     row; only edges past K (hub rows) load el and recompute alpha and g;
//   - one reciprocal of den per (row, head) replaces a division per edge;
//   - the per-slot sums fold into slot 0 with __shfl_down_sync at the row's
//     end (dattn_l at the kernel's end); enough blocks to fill every SM once
//     (the caller asks the occupancy of the instantiation) stride over rows.
// The caller works the geometry out (ops/gat_cuda.py `bwd_geometry`) and the
// kernel checks it.
//
// The standalone segment softmax (edge_softmax_fwd, edge_softmax_bwd)
// replaces :_smx_fwd_kernel (:694) and :_smx_bwd_kernel (:712), which run
// the same one-hot slot-space reduction per dst block. Here scores are f32
// [E, H] in dst-sorted edge order, so a dst row's scores are one contiguous
// run of (end - start) * H floats. One warp owns a row; its lanes cover
// (edge, head) pairs: G lanes per edge (G the smallest power of two >= H, at
// most 32, more heads in further passes) and 32 / G edges per step, so the
// warp reads the run with consecutive lanes on consecutive floats. The
// forward finds each head's segment max (per lane, merged with
// __shfl_xor_sync), sums exp(s - max) the same way with a compensated sum,
// then writes alpha = exp(s - max) / sum: the segment's own max, not the
// TPU kernel's block max (gat_pallas.py:700). Each term is formed with the
// final max, not rescaled as an online softmax would rescale it: on a
// 20,000-edge segment the rescaling cost more accuracy than the tests
// allow. The backward sums t = sum_seg(alpha * dalpha) the same way and
// writes
// ds = alpha * dalpha - alpha * t. A row without in-edges writes nothing.
// Both are bound by bytes (each reads its [E, H] inputs once and writes
// [E, H] once; a few flops per element): the reads and writes are
// coalesced, which is all the design does about it.
//
// Interface: plain C, called through ctypes. Every entry point launches on
// the given stream, never synchronises, allocates nothing, and returns
// cudaGetLastError() (or cudaErrorInvalidValue for a shape it does not take).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>

#include <cstdint>

namespace {

constexpr int kWarps = 8;  // warps per block
constexpr unsigned kFull = 0xffffffffu;

// VEC bf16 values in one load or store of VEC * 2 bytes. The pairs are
// unpacked with bit operations (element 0 is the low half of a word), so no
// local variable has its address taken.
__device__ __forceinline__ void unpack2(unsigned w, float* out) {
  out[0] = __uint_as_float(w << 16);
  out[1] = __uint_as_float(w & 0xffff0000u);
}

__device__ __forceinline__ unsigned pack2(const float* in) {
  return static_cast<unsigned>(__bfloat16_as_ushort(__float2bfloat16(in[0]))) |
         (static_cast<unsigned>(__bfloat16_as_ushort(__float2bfloat16(in[1]))) << 16);
}

template <int VEC>
__device__ __forceinline__ void load_bf16(const __nv_bfloat16* p, float* out) {
  if constexpr (VEC == 1) {
    out[0] = __bfloat162float(*p);
  } else if constexpr (VEC == 2) {
    unpack2(*reinterpret_cast<const unsigned*>(p), out);
  } else if constexpr (VEC == 4) {
    const uint2 v = *reinterpret_cast<const uint2*>(p);
    unpack2(v.x, out);
    unpack2(v.y, out + 2);
  } else {
    const uint4 v = *reinterpret_cast<const uint4*>(p);
    unpack2(v.x, out);
    unpack2(v.y, out + 2);
    unpack2(v.z, out + 4);
    unpack2(v.w, out + 6);
  }
}

template <int VEC>
__device__ __forceinline__ void store_bf16(__nv_bfloat16* p, const float* in) {
  if constexpr (VEC == 1) {
    *p = __float2bfloat16(in[0]);
  } else if constexpr (VEC == 2) {
    *reinterpret_cast<unsigned*>(p) = pack2(in);
  } else if constexpr (VEC == 4) {
    *reinterpret_cast<uint2*>(p) = make_uint2(pack2(in), pack2(in + 2));
  } else {
    *reinterpret_cast<uint4*>(p) =
        make_uint4(pack2(in), pack2(in + 2), pack2(in + 4), pack2(in + 6));
  }
}

__device__ __forceinline__ float leaky(float x, float slope) {
  return x >= 0.f ? x : slope * x;
}

// dropout weight of edge e, head h: keep / keep_prob, or 1 without a mask
__device__ __forceinline__ float drop_weight(const uint8_t* keep, int64_t e, int H, int h,
                                             float inv_keep) {
  if (keep == nullptr) return 1.f;
  return keep[e * H + h] ? inv_keep : 0.f;
}

template <int VEC, int REPS>
__global__ void __launch_bounds__(kWarps * 32)
gat_fwd_kernel(const int32_t* __restrict__ indptr, const int32_t* __restrict__ src_of,
               const __nv_bfloat16* __restrict__ feat, const float* __restrict__ el,
               const __nv_bfloat16* __restrict__ er, const uint8_t* __restrict__ keep,
               float inv_keep, float slope, float* __restrict__ out,
               float* __restrict__ smax, float* __restrict__ denom, int n_rows, int H,
               int D, int lanes) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (row >= n_rows) return;  // the whole warp leaves together
  const int start = indptr[row];
  const int end = indptr[row + 1];
  const int hd = H * D;
  const int sub = lane & (lanes - 1);

  for (int h0 = 0; h0 < H; h0 += 32 / lanes) {
    const int h = h0 + lane / lanes;
    const bool head_ok = h < H;
    const float er_v = head_ok ? __bfloat162float(er[static_cast<int64_t>(row) * H + h]) : 0.f;
    float m = -CUDART_INF_F;
    float den = 0.f;
    float acc[REPS][VEC];
#pragma unroll
    for (int r = 0; r < REPS; ++r)
#pragma unroll
      for (int k = 0; k < VEC; ++k) acc[r][k] = 0.f;

    for (int e0 = start; e0 < end; e0 += 32) {
      const int n = min(32, end - e0);
      const int mine = lane < n ? src_of[e0 + lane] : 0;
      for (int j = 0; j < n; ++j) {
        const int src = __shfl_sync(kFull, mine, j);
        if (!head_ok) continue;
        const float s = leaky(el[static_cast<int64_t>(src) * H + h] + er_v, slope);
        if (s > m) {  // rescale what was summed under the old max
          const float c = expf(m - s);
          den *= c;
#pragma unroll
          for (int r = 0; r < REPS; ++r)
#pragma unroll
            for (int k = 0; k < VEC; ++k) acc[r][k] *= c;
          m = s;
        }
        const float p = expf(s - m);
        den += p;
        const float pw = p * drop_weight(keep, e0 + j, H, h, inv_keep);
        const __nv_bfloat16* frow = feat + static_cast<int64_t>(src) * hd + h * D;
#pragma unroll
        for (int r = 0; r < REPS; ++r) {
          const int col = (r * lanes + sub) * VEC;
          if (col < D) {
            float f[VEC];
            load_bf16<VEC>(frow + col, f);
#pragma unroll
            for (int k = 0; k < VEC; ++k) acc[r][k] += pw * f[k];
          }
        }
      }
    }
    if (!head_ok) continue;
    float* orow = out + static_cast<int64_t>(row) * hd + h * D;
#pragma unroll
    for (int r = 0; r < REPS; ++r) {
      const int col = (r * lanes + sub) * VEC;
      if (col < D) {
#pragma unroll
        for (int k = 0; k < VEC; ++k) orow[col + k] = den > 0.f ? acc[r][k] / den : 0.f;
      }
    }
    if (sub == 0) {
      smax[static_cast<int64_t>(row) * H + h] = den > 0.f ? m : 0.f;
      denom[static_cast<int64_t>(row) * H + h] = den;
    }
  }
}

// per-edge quantities of the backward, recomputed from the forward's inputs
struct EdgeTerms {
  float s_pre;  // el + er, before leaky_relu
  float alpha;  // exp(s - max) / den
  float w;      // dropout weight
};

__device__ __forceinline__ EdgeTerms edge_terms(float el_src, float er_v, float m_v,
                                                float inv_den, const uint8_t* keep, int64_t e,
                                                int H, int h, float inv_keep, float slope) {
  EdgeTerms t;
  t.s_pre = el_src + er_v;
  t.alpha = expf(leaky(t.s_pre, slope) - m_v) * inv_den;
  t.w = drop_weight(keep, e, H, h, inv_keep);
  return t;
}

// sum over the lh lanes of a head (lh need not be a power of two), whose
// first lane is lane - sub; every lane of the warp must call it and gets its
// head's sum
__device__ __forceinline__ float head_sum(float v, int sub, int lh) {
  for (int off = 1; off < lh; off <<= 1) {
    const float o = __shfl_down_sync(kFull, v, off);
    if (sub + off < lh) v += o;
  }
  return __shfl_sync(kFull, v, (threadIdx.x & 31) - sub);
}

// fold the per-slot values of `slots` slots of `le` lanes each onto slot 0
// (slots [h, s) onto [0, s - h)); every lane of the warp must call it
__device__ __forceinline__ float slot_fold(float v, int q, int slots, int le) {
  for (int s = slots; s > 1;) {
    const int h = (s + 1) >> 1;
    const float o = __shfl_down_sync(kFull, v, h * le);
    if (q + h < s) v += o;
    s = h;
  }
  return v;
}

// the lane's REPS groups of VEC columns of one bf16 feature row (zeros for
// a group whose bit in `cols` is clear)
template <int VEC, int REPS>
__device__ __forceinline__ void load_slice(const __nv_bfloat16* frow, unsigned cols, int lh,
                                           int sub, float (&f)[REPS][VEC]) {
#pragma unroll
  for (int r = 0; r < REPS; ++r) {
    if (cols >> r & 1u) {
      load_bf16<VEC>(frow + (r * lh + sub) * VEC, f[r]);
    } else {
#pragma unroll
      for (int k = 0; k < VEC; ++k) f[r][k] = 0.f;
    }
  }
}

// this lane's part of <feature slice, dout slice>
template <int VEC, int REPS>
__device__ __forceinline__ float dot(const float (&f)[REPS][VEC], const float (&go)[REPS][VEC],
                                     unsigned cols) {
  float part = 0.f;
#pragma unroll
  for (int r = 0; r < REPS; ++r)
    if (cols >> r & 1u)
#pragma unroll
      for (int k = 0; k < VEC; ++k) part += f[r][k] * go[r][k];
  return part;
}

// At most 8 columns per lane, ptxas left to itself trims some of these
// instantiations to an occupancy target by spilling; asking 3 resident
// blocks per SM gives it a register budget (up to 85) that needs no spill.
template <int VEC, int REPS>
__global__ void __launch_bounds__(kWarps * 32, VEC * REPS <= 8 ? 3 : 1)
gat_bwd_kernel(const int32_t* __restrict__ indptr, const int32_t* __restrict__ src_of,
               const __nv_bfloat16* __restrict__ feat, const float* __restrict__ el,
               const __nv_bfloat16* __restrict__ er, const uint8_t* __restrict__ keep,
               float inv_keep, float slope, const float* __restrict__ smax,
               const float* __restrict__ denom, const float* __restrict__ dout,
               const __nv_bfloat16* __restrict__ attn_l, float* __restrict__ der,
               __nv_bfloat16* __restrict__ msg, float* __restrict__ dal_part, int n_rows, int H,
               int D, int lh, int hp, int slots, int kcache) {
  // (alpha, w, w g, leaky_relu' factor) of the first kcache edges of the
  // warp's row, per head of the pass: [kWarps][kcache][hp]
  extern __shared__ float4 edge_cache[];
  const int lane = threadIdx.x & 31;
  const int warp = blockIdx.x * kWarps + (threadIdx.x >> 5);
  const int n_warps = gridDim.x * kWarps;
  float4* cache = edge_cache + (threadIdx.x >> 5) * kcache * hp;
  const int hd = H * D;
  const int le = hp * lh;  // lanes per edge
  const int q = lane / le;
  const int hh = (lane - q * le) / lh;
  const int sub = lane - q * le - hh * lh;

  for (int h0 = 0; h0 < H; h0 += hp) {  // one pass unless H * LH > 32
    const int h = h0 + hh;
    const bool lane_ok = q < slots && h < H;
    unsigned cols = 0;  // bit r: this lane's column group r lies in the head
#pragma unroll
    for (int r = 0; r < REPS; ++r) cols |= (lane_ok && (r * lh + sub) * VEC < D ? 1u : 0u) << r;
    float dal[REPS][VEC];  // this lane's dattn_l partial for its columns
#pragma unroll
    for (int r = 0; r < REPS; ++r)
#pragma unroll
      for (int k = 0; k < VEC; ++k) dal[r][k] = 0.f;

    for (int row = warp; row < n_rows; row += n_warps) {  // warp-uniform
      const int start = indptr[row];
      const int end = indptr[row + 1];
      const int64_t vh = static_cast<int64_t>(row) * H + h;
      if (start == end) {  // no in-edges: nothing flows back
        if (lane_ok && q == 0 && sub == 0) der[vh] = 0.f;
        continue;
      }
      const float er_v = lane_ok ? __bfloat162float(er[vh]) : 0.f;
      const float m_v = lane_ok ? smax[vh] : 0.f;
      // den >= 1 (the max term is exp(0)), so the fast reciprocal (2 ulp)
      // is safe, and it calls no division subroutine
      const float inv_den = lane_ok ? __fdividef(1.f, denom[vh]) : 0.f;
      const float* gorow = dout + static_cast<int64_t>(row) * hd + h * D;
      float go[REPS][VEC];  // dout[v, h, this lane's columns]
#pragma unroll
      for (int r = 0; r < REPS; ++r)
#pragma unroll
        for (int k = 0; k < VEC; ++k)
          go[r][k] = (cols >> r & 1u) ? gorow[(r * lh + sub) * VEC + k] : 0.f;

      // pass 1: alpha, w and g of every edge, t, and the cache
      float t = 0.f;
      for (int e0 = start; e0 < end; e0 += 32) {
        const int n = min(32, end - e0);
        const int mine = lane < n ? src_of[e0 + lane] : 0;
        const int steps = (n + slots - 1) / slots;  // warp-uniform
        for (int j = 0; j < steps; ++j) {
          const int k = j * slots + q;
          const int src = __shfl_sync(kFull, mine, k & 31);
          const bool on = lane_ok && k < n;
          EdgeTerms et{0.f, 0.f, 0.f};
          float f[REPS][VEC];
          if (on) {
            et = edge_terms(el[static_cast<int64_t>(src) * H + h], er_v, m_v, inv_den, keep, e0 + k,
                            H, h, inv_keep, slope);
            load_slice<VEC, REPS>(feat + static_cast<int64_t>(src) * hd + h * D, cols, lh, sub, f);
          }
          const float g = head_sum(on ? dot<VEC, REPS>(f, go, cols) : 0.f, sub, lh);
          if (!on) continue;
          const float wg = et.w * g;
          t += et.alpha * wg;
          const int ro = e0 - start + k;  // edge of the row
          if (ro < kcache && sub == 0)
            cache[ro * hp + hh] = make_float4(et.alpha, et.w, wg, et.s_pre >= 0.f ? 1.f : slope);
        }
      }
      t = __shfl_sync(kFull, slot_fold(t, q, slots, le), lane - q * le);  // the row's t
      __syncwarp();  // the cache written above is read by other lanes below

      // pass 2: the softmax VJP per edge, from the cache (recomputed past
      // it); the feature slice is read again for dattn_l, attn_l from L1
      const __nv_bfloat16* alrow = attn_l + h * D;
      float der_acc = 0.f;
      for (int e0 = start; e0 < end; e0 += 32) {
        const int n = min(32, end - e0);
        const int mine = lane < n ? src_of[e0 + lane] : 0;
        const int steps = (n + slots - 1) / slots;
        for (int j = 0; j < steps; ++j) {
          const int k = j * slots + q;
          const int src = __shfl_sync(kFull, mine, k & 31);
          const bool on = lane_ok && k < n;
          const bool cached = e0 - start + (j + 1) * slots <= kcache;  // warp-uniform
          float4 es = make_float4(0.f, 0.f, 0.f, 0.f);  // (alpha, w, w g, leaky_relu')
          float f[REPS][VEC];
          if (on) {
            if (cached) {
              es = cache[(e0 - start + k) * hp + hh];
            } else {
              const EdgeTerms et = edge_terms(el[static_cast<int64_t>(src) * H + h], er_v, m_v,
                                              inv_den, keep, e0 + k, H, h, inv_keep, slope);
              es = make_float4(et.alpha, et.w, 0.f, et.s_pre >= 0.f ? 1.f : slope);
            }
            load_slice<VEC, REPS>(feat + static_cast<int64_t>(src) * hd + h * D, cols, lh, sub, f);
          }
          if (!cached) es.z = es.y * head_sum(on ? dot<VEC, REPS>(f, go, cols) : 0.f, sub, lh);
          if (!on) continue;
          const float ds_pre = es.w * (es.x * (es.z - t));
          const float aw = es.x * es.y;
          der_acc += ds_pre;
          __nv_bfloat16* mrow = msg + static_cast<int64_t>(e0 + k) * hd + h * D;
#pragma unroll
          for (int r = 0; r < REPS; ++r)
            if (cols >> r & 1u) {
              const int col = (r * lh + sub) * VEC;
              float al[VEC], mv[VEC];
              load_bf16<VEC>(alrow + col, al);
#pragma unroll
              for (int c = 0; c < VEC; ++c) {
                mv[c] = aw * go[r][c] + ds_pre * al[c];
                dal[r][c] += ds_pre * f[r][c];
              }
              store_bf16<VEC>(mrow + col, mv);
            }
        }
      }
      der_acc = slot_fold(der_acc, q, slots, le);
      if (lane_ok && q == 0 && sub == 0) der[vh] = der_acc;
      __syncwarp();  // every lane is done with the cache before the next row
    }

    // fold the slots' dattn_l partials onto slot 0, which writes them
#pragma unroll
    for (int r = 0; r < REPS; ++r)
#pragma unroll
      for (int k = 0; k < VEC; ++k) dal[r][k] = slot_fold(dal[r][k], q, slots, le);
    if (q != 0) continue;
    float* prow = dal_part + static_cast<int64_t>(warp) * hd + h * D;
#pragma unroll
    for (int r = 0; r < REPS; ++r)
      if (cols >> r & 1u)
#pragma unroll
        for (int k = 0; k < VEC; ++k) prow[(r * lh + sub) * VEC + k] = dal[r][k];
  }
}

struct Geometry {
  int vec, lanes, reps;
};

constexpr int kMaxReps = 4;

// the forward's lane layout for per-head width d (see the note at the top);
// vec also divides the alignment of every base pointer it is used with.
// reps == 0 marks a width the kernel does not take.
Geometry geometry(int d, uintptr_t align) {
  int vec = 8;
  while (vec > 1 && (d % vec != 0 || align % (vec * sizeof(__nv_bfloat16)) != 0)) vec /= 2;
  const int groups = d / vec;  // vec-wide groups per head
  int lanes = 1;
  while (lanes < groups && lanes < 32) lanes *= 2;
  int reps = 1;
  while (reps * lanes < groups) reps *= 2;
  return {vec, lanes, reps <= kMaxReps ? reps : 0};
}

#define GAT_CASES(X) \
  X(1, 1) X(1, 2) X(1, 4) X(2, 1) X(2, 2) X(2, 4) X(4, 1) X(4, 2) X(4, 4) X(8, 1) X(8, 2) X(8, 4)

// segment softmax: lanes per edge, G a power of two (see the note at the top)
__global__ void __launch_bounds__(kWarps * 32)
edge_softmax_fwd_kernel(const int32_t* __restrict__ indptr, const float* __restrict__ scores,
                        float* __restrict__ alpha, int n_rows, int H, int G) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (row >= n_rows) return;  // the whole warp leaves together
  const int start = indptr[row];
  const int end = indptr[row + 1];
  const int per = 32 / G;  // edges per step
  const int slot = lane / G;

  for (int h0 = 0; h0 < H; h0 += G) {
    const int h = h0 + (lane & (G - 1));
    const bool head_ok = h < H;
    // the segment max, then the sum of exp(s - max): every term is formed
    // with the final max, as the plain version forms it, and the sum is
    // compensated (Kahan's way), since with H >= 32 one lane sums a whole
    // segment, and a plain f32 sum of a 20,000-edge segment's exponentials
    // is off by about 1e-5 of itself
    float m = -CUDART_INF_F;
    if (head_ok)
      for (int e = start + slot; e < end; e += per)
        m = fmaxf(m, scores[static_cast<int64_t>(e) * H + h]);
    for (int off = 16; off >= G; off >>= 1) m = fmaxf(m, __shfl_xor_sync(kFull, m, off));
    float den = 0.f;
    float comp = 0.f;  // the sum's lost low-order part
    if (head_ok) {
      for (int e = start + slot; e < end; e += per) {
        const float y = expf(scores[static_cast<int64_t>(e) * H + h] - m) - comp;
        const float sum = den + y;
        comp = (sum - den) - y;
        den = sum;
      }
      den -= comp;
    }
    for (int off = 16; off >= G; off >>= 1) den += __shfl_xor_sync(kFull, den, off);
    if (!head_ok) continue;
    for (int e = start + slot; e < end; e += per) {
      const int64_t i = static_cast<int64_t>(e) * H + h;
      alpha[i] = expf(scores[i] - m) / den;
    }
  }
}

__global__ void __launch_bounds__(kWarps * 32)
edge_softmax_bwd_kernel(const int32_t* __restrict__ indptr, const float* __restrict__ alpha,
                        const float* __restrict__ dalpha, float* __restrict__ ds, int n_rows,
                        int H, int G) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (row >= n_rows) return;  // the whole warp leaves together
  const int start = indptr[row];
  const int end = indptr[row + 1];
  const int per = 32 / G;
  const int slot = lane / G;

  for (int h0 = 0; h0 < H; h0 += G) {
    const int h = h0 + (lane & (G - 1));
    const bool head_ok = h < H;
    float t = 0.f;
    if (head_ok) {
      for (int e = start + slot; e < end; e += per) {
        const int64_t i = static_cast<int64_t>(e) * H + h;
        t += alpha[i] * dalpha[i];
      }
    }
    for (int off = 16; off >= G; off >>= 1) t += __shfl_xor_sync(kFull, t, off);
    if (!head_ok) continue;
    for (int e = start + slot; e < end; e += per) {
      const int64_t i = static_cast<int64_t>(e) * H + h;
      const float a = alpha[i];
      ds[i] = a * dalpha[i] - a * t;
    }
  }
}

int lanes_per_edge(int H) {
  int g = 1;
  while (g < H && g < 32) g *= 2;
  return g;
}

// the backward's lane layout (see the note at the top), as
// ops/gat_cuda.py `bwd_geometry` works it out
struct BwdGeometry {
  int vec, reps, lh, hp, slots, kcache;
};

int bwd_smem_bytes(const BwdGeometry& g) {
  return kWarps * g.kcache * g.hp * static_cast<int>(sizeof(float4));
}

// a geometry the kernel instantiates and that covers every column of every
// head, keeps each lane's loads aligned and fits the shared memory a block
// gets without opting in
bool bwd_geometry_ok(const BwdGeometry& g, int H, int D, uintptr_t align) {
  return (g.vec == 1 || g.vec == 2 || g.vec == 4 || g.vec == 8) && D % g.vec == 0 &&
         align % (g.vec * sizeof(__nv_bfloat16)) == 0 &&
         (g.reps == 1 || g.reps == 2 || g.reps == 4) && g.lh >= 1 &&
         g.lh * g.reps * g.vec >= D && g.hp >= 1 && g.hp <= H && g.slots >= 1 &&
         g.hp * g.lh * g.slots <= 32 && (g.slots == 1 || g.hp == H) && g.kcache >= 0 &&
         bwd_smem_bytes(g) <= 48 * 1024;
}

}  // namespace

extern "C" {

// feat bf16 [n_src, H, D]; el f32 [n_src, H]; er bf16 [n_rows, H];
// keep uint8 [E, H] or null; out f32 [n_rows, H, D]; smax, denom f32 [n_rows, H]
int gat_fwd(const void* indptr, const void* src_of, const void* feat, const void* el,
            const void* er, const void* keep, float inv_keep, float slope, void* out,
            void* smax, void* denom, int n_rows, int H, int D, void* stream) {
  if (n_rows <= 0 || H <= 0 || D <= 0) return static_cast<int>(cudaGetLastError());
  const Geometry geo = geometry(D, reinterpret_cast<uintptr_t>(feat));
  const dim3 grid((n_rows + kWarps - 1) / kWarps), block(kWarps * 32);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define FWD_CASE(V, R)                                                                   \
  case V * 16 + R:                                                                      \
    gat_fwd_kernel<V, R><<<grid, block, 0, st>>>(                                       \
        static_cast<const int32_t*>(indptr), static_cast<const int32_t*>(src_of),       \
        static_cast<const __nv_bfloat16*>(feat), static_cast<const float*>(el),         \
        static_cast<const __nv_bfloat16*>(er), static_cast<const uint8_t*>(keep),       \
        inv_keep, slope, static_cast<float*>(out), static_cast<float*>(smax),           \
        static_cast<float*>(denom), n_rows, H, D, geo.lanes);                           \
    break;
  switch (geo.vec * 16 + geo.reps) {
    GAT_CASES(FWD_CASE)
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
#undef FWD_CASE
  return static_cast<int>(cudaGetLastError());
}

// as gat_fwd, plus smax, denom from it; dout f32 [n_rows, H, D];
// attn_l bf16 [H, D]; der f32 [n_rows, H]; msg bf16 [E, H, D] (dst-sorted
// edge order); dal_part f32 [n_blocks * 8, H, D], one partial per warp;
// (vec, reps, lh, hp, slots, kcache) as ops/gat_cuda.py `bwd_geometry`
// gives them
int gat_bwd(const void* indptr, const void* src_of, const void* feat, const void* el,
            const void* er, const void* keep, float inv_keep, float slope, const void* smax,
            const void* denom, const void* dout, const void* attn_l, void* der, void* msg,
            void* dal_part, int n_rows, int H, int D, int n_blocks, int vec, int reps, int lh,
            int hp, int slots, int kcache, void* stream) {
  if (n_rows <= 0 || H <= 0 || D <= 0 || n_blocks <= 0)
    return static_cast<int>(cudaGetLastError());
  const BwdGeometry geo{vec, reps, lh, hp, slots, kcache};
  const uintptr_t align = reinterpret_cast<uintptr_t>(feat) | reinterpret_cast<uintptr_t>(msg);
  if (!bwd_geometry_ok(geo, H, D, align)) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(n_blocks), block(kWarps * 32);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define BWD_CASE(V, R)                                                                      \
  case V * 16 + R:                                                                          \
    gat_bwd_kernel<V, R><<<grid, block, bwd_smem_bytes(geo), st>>>(                         \
        static_cast<const int32_t*>(indptr), static_cast<const int32_t*>(src_of),          \
        static_cast<const __nv_bfloat16*>(feat), static_cast<const float*>(el),            \
        static_cast<const __nv_bfloat16*>(er), static_cast<const uint8_t*>(keep),          \
        inv_keep, slope, static_cast<const float*>(smax), static_cast<const float*>(denom), \
        static_cast<const float*>(dout), static_cast<const __nv_bfloat16*>(attn_l),        \
        static_cast<float*>(der), static_cast<__nv_bfloat16*>(msg),                        \
        static_cast<float*>(dal_part), n_rows, H, D, lh, hp, slots, kcache);               \
    break;
  switch (vec * 16 + reps) {
    GAT_CASES(BWD_CASE)
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
#undef BWD_CASE
  return static_cast<int>(cudaGetLastError());
}

// blocks of gat_bwd's instantiation for (vec, reps) that one SM holds at
// once with the cache of (kcache, hp); a negative CUDA error code on failure
int gat_bwd_blocks_per_sm(int vec, int reps, int kcache, int hp) {
  const int smem = bwd_smem_bytes(BwdGeometry{vec, reps, 1, hp, 1, kcache});
  int n = 0;
  cudaError_t err = cudaErrorInvalidValue;
#define OCC_CASE(V, R)                                                                      \
  case V * 16 + R:                                                                          \
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, gat_bwd_kernel<V, R>,           \
                                                        kWarps * 32, smem);                 \
    break;
  switch (vec * 16 + reps) {
    GAT_CASES(OCC_CASE)
    default:
      break;
  }
#undef OCC_CASE
  return err == cudaSuccess ? n : -static_cast<int>(err);
}

// scores f32 [E, H] in dst-sorted edge order; alpha f32 [E, H]
int edge_softmax_fwd(const void* indptr, const void* scores, void* alpha, int n_rows, int H,
                     void* stream) {
  if (n_rows <= 0 || H <= 0) return static_cast<int>(cudaGetLastError());
  const dim3 grid((n_rows + kWarps - 1) / kWarps), block(kWarps * 32);
  edge_softmax_fwd_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(indptr), static_cast<const float*>(scores),
      static_cast<float*>(alpha), n_rows, H, lanes_per_edge(H));
  return static_cast<int>(cudaGetLastError());
}

// alpha, dalpha, ds f32 [E, H] in dst-sorted edge order
int edge_softmax_bwd(const void* indptr, const void* alpha, const void* dalpha, void* ds,
                     int n_rows, int H, void* stream) {
  if (n_rows <= 0 || H <= 0) return static_cast<int>(cudaGetLastError());
  const dim3 grid((n_rows + kWarps - 1) / kWarps), block(kWarps * 32);
  edge_softmax_bwd_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(indptr), static_cast<const float*>(alpha),
      static_cast<const float*>(dalpha), static_cast<float*>(ds), n_rows, H,
      lanes_per_edge(H));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
