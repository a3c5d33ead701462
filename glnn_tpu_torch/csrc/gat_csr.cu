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
// Lane layout. D = per-head width, H = heads. A lane holds VEC consecutive
// features (VEC the largest power of two <= 8 dividing D: one load of up to
// 16 bytes), REPS such groups strided by LANES * VEC, all in one head. LANES
// (a power of two <= 32) lanes cover a head, 32 / LANES heads share a pass
// over the row's edges, and ceil(H / (32 / LANES)) passes cover all heads.
// The main path's shapes: (H, D) = (8, 16) gives VEC 8, LANES 2, one pass;
// (1, 40) gives VEC 8, LANES 8, one pass. Per-head dot products reduce over
// the head's LANES lanes with __shfl_xor_sync.
//
// Forward (gat_fwd): per dst row and head, an online softmax: the running
// segment max m and denominator den (of the UNDROPPED weights, dgl GATConv
// semantics) are rescaled when m rises, and the dropped weights
// p * keep / keep_prob scale the bf16 source rows into an f32 accumulator.
// out = acc / den in f32. The segment's own max is subtracted, so no segment
// underflows, unlike the TPU kernel's block max (gat_pallas.py:35-42). A row
// with no in-edges writes zeros (and max 0, den 0). The per-dst max and den
// [N, H] are written for the backward.
//
// Backward (gat_bwd): per dst row and head, two passes over the in-edges
// recompute s and alpha = exp(s - max) / den from the saved inputs. Pass 1
// sums t = sum_e alpha_e w_e g_e with g_e = <feat[src,h,:], dout[v,h,:]>
// and w_e the dropout weight; pass 2 forms the softmax VJP
// ds = alpha (w g - t), ds_pre = ds through leaky_relu' (the s_pre >= 0
// branch, as the JAX kernel), and writes
//   der[v,h]        = sum_e ds_pre                        (f32)
//   msg[e,h*D+j]    = alpha w dout[v,h,j] + ds_pre attn_l[h,j]   (bf16)
//   dal_part[warp]  += ds_pre feat[src,h,:]               (f32, per warp)
// The whole chain is f32: bf16 there gave ~10% gradient error
// (gat_pallas.py:237-239). Warps stride over rows and each keeps its own
// dattn_l partial, which the caller sums: no atomics, a deterministic result.
// The message, in dst-sorted edge order, is reduced over sources by the CSR
// SpMM kernel (spmm_csr.cu) over the transposed CSR, as _fused_bwd does with
// segment_reduce (gat_pallas.py:494).
//
// Bound on an H100: bytes. Per call the forward must read the bf16 features
// once (most of the E gathers hit the 50 MB L2 at ogbn-arxiv scale), el, er,
// the indices and the [E, H] keep mask, and write out, max and den; its
// arithmetic (about 2 E H D flops plus E H exponentials) is far below the
// card's rate. The backward's largest term is its [E, H*D] bf16 message write
// (about 650 MB at E = 2.5M, H*D = 128). The design keeps loads wide (VEC)
// and fetches 32 indices per warp at once, broadcast with __shfl_sync.
//
// The standalone segment softmax (edge_softmax_fwd, edge_softmax_bwd)
// replaces :_smx_fwd_kernel (:694) and :_smx_bwd_kernel (:712), which run
// the same one-hot slot-space reduction per dst block. Here scores are f32
// [E, H] in dst-sorted edge order, so a dst row's scores are one contiguous
// run of (end - start) * H floats. One warp owns a row; its lanes cover
// (edge, head) pairs: G lanes per edge (G the smallest power of two >= H, at
// most 32, more heads in further passes) and 32 / G edges per step, so the
// warp reads the run with consecutive lanes on consecutive floats. The
// forward keeps a running max and sum per lane (rescaled when the max
// rises), merges the lanes of each head with __shfl_xor_sync, then writes
// alpha = exp(s - max) / sum in a second pass: the segment's own max, not
// the TPU kernel's block max (gat_pallas.py:700). The backward sums
// t = sum_seg(alpha * dalpha) the same way and writes
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

// sum over the `lanes` lanes (a power of two) of each aligned lane group;
// every lane of the warp must call it
__device__ __forceinline__ float group_sum(float v, int lanes) {
  for (int off = lanes >> 1; off > 0; off >>= 1) v += __shfl_xor_sync(kFull, v, off);
  return v;
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

__device__ __forceinline__ EdgeTerms edge_terms(const float* el, int src, int H, int h, float er_v,
                                                float m_v, float den_v, const uint8_t* keep,
                                                int64_t e, float inv_keep, float slope) {
  EdgeTerms t;
  t.s_pre = el[static_cast<int64_t>(src) * H + h] + er_v;
  t.alpha = expf(leaky(t.s_pre, slope) - m_v) / den_v;
  t.w = drop_weight(keep, e, H, h, inv_keep);
  return t;
}

template <int VEC, int REPS>
__global__ void __launch_bounds__(kWarps * 32)
gat_bwd_kernel(const int32_t* __restrict__ indptr, const int32_t* __restrict__ src_of,
               const __nv_bfloat16* __restrict__ feat, const float* __restrict__ el,
               const __nv_bfloat16* __restrict__ er, const uint8_t* __restrict__ keep,
               float inv_keep, float slope, const float* __restrict__ smax,
               const float* __restrict__ denom, const float* __restrict__ dout,
               const __nv_bfloat16* __restrict__ attn_l, float* __restrict__ der,
               __nv_bfloat16* __restrict__ msg, float* __restrict__ dal_part, int n_rows, int H,
               int D, int lanes) {
  const int lane = threadIdx.x & 31;
  const int warp = blockIdx.x * kWarps + (threadIdx.x >> 5);
  const int n_warps = gridDim.x * kWarps;
  const int hd = H * D;
  const int sub = lane & (lanes - 1);

  for (int h0 = 0; h0 < H; h0 += 32 / lanes) {
    const int h = h0 + lane / lanes;
    const bool head_ok = h < H;
    float al[REPS][VEC];   // this lane's columns of attn_l (bf16 values)
    float dal[REPS][VEC];  // this warp's dattn_l partial for those columns
#pragma unroll
    for (int r = 0; r < REPS; ++r) {
      const int col = (r * lanes + sub) * VEC;
      const bool on = head_ok && col < D;
#pragma unroll
      for (int k = 0; k < VEC; ++k) {
        al[r][k] = on ? __bfloat162float(attn_l[h * D + col + k]) : 0.f;
        dal[r][k] = 0.f;
      }
    }

    for (int row = warp; row < n_rows; row += n_warps) {  // warp-uniform
      const int start = indptr[row];
      const int end = indptr[row + 1];
      const int64_t vh = static_cast<int64_t>(row) * H + h;
      if (start == end) {  // no in-edges: nothing flows back
        if (head_ok && sub == 0) der[vh] = 0.f;
        continue;
      }
      const float er_v = head_ok ? __bfloat162float(er[vh]) : 0.f;
      const float m_v = head_ok ? smax[vh] : 0.f;
      const float den_v = head_ok ? denom[vh] : 1.f;
      float go[REPS][VEC];  // dout[v, h, this lane's columns]
#pragma unroll
      for (int r = 0; r < REPS; ++r) {
        const int col = (r * lanes + sub) * VEC;
        const bool on = head_ok && col < D;
#pragma unroll
        for (int k = 0; k < VEC; ++k)
          go[r][k] = on ? dout[static_cast<int64_t>(row) * hd + h * D + col + k] : 0.f;
      }

      // pass 1: t = sum_e alpha_e w_e g_e
      float t = 0.f;
      for (int e0 = start; e0 < end; e0 += 32) {
        const int n = min(32, end - e0);
        const int mine = lane < n ? src_of[e0 + lane] : 0;
        for (int j = 0; j < n; ++j) {
          const int src = __shfl_sync(kFull, mine, j);
          float part = 0.f;
          EdgeTerms et{0.f, 0.f, 0.f};
          if (head_ok) {
            et = edge_terms(el, src, H, h, er_v, m_v, den_v, keep, e0 + j, inv_keep, slope);
            const __nv_bfloat16* frow = feat + static_cast<int64_t>(src) * hd + h * D;
#pragma unroll
            for (int r = 0; r < REPS; ++r) {
              const int col = (r * lanes + sub) * VEC;
              if (col < D) {
                float f[VEC];
                load_bf16<VEC>(frow + col, f);
#pragma unroll
                for (int k = 0; k < VEC; ++k) part += f[k] * go[r][k];
              }
            }
          }
          const float g = group_sum(part, lanes);
          t += et.alpha * et.w * g;
        }
      }

      // pass 2: the softmax VJP, der, the message and dattn_l
      float der_acc = 0.f;
      for (int e0 = start; e0 < end; e0 += 32) {
        const int n = min(32, end - e0);
        const int mine = lane < n ? src_of[e0 + lane] : 0;
        for (int j = 0; j < n; ++j) {
          const int src = __shfl_sync(kFull, mine, j);
          const int64_t e = e0 + j;
          float part = 0.f;
          float f[REPS][VEC];
          EdgeTerms et{0.f, 0.f, 0.f};
          if (head_ok) {
            et = edge_terms(el, src, H, h, er_v, m_v, den_v, keep, e, inv_keep, slope);
            const __nv_bfloat16* frow = feat + static_cast<int64_t>(src) * hd + h * D;
#pragma unroll
            for (int r = 0; r < REPS; ++r) {
              const int col = (r * lanes + sub) * VEC;
              if (col < D) {
                load_bf16<VEC>(frow + col, f[r]);
#pragma unroll
                for (int k = 0; k < VEC; ++k) part += f[r][k] * go[r][k];
              }
            }
          }
          const float g = group_sum(part, lanes);
          if (!head_ok) continue;
          const float ds = et.alpha * (et.w * g - t);
          const float ds_pre = et.s_pre >= 0.f ? ds : slope * ds;
          der_acc += ds_pre;
          const float aw = et.alpha * et.w;
          __nv_bfloat16* mrow = msg + e * hd + h * D;
#pragma unroll
          for (int r = 0; r < REPS; ++r) {
            const int col = (r * lanes + sub) * VEC;
            if (col < D) {
              float mv[VEC];
#pragma unroll
              for (int k = 0; k < VEC; ++k) {
                mv[k] = aw * go[r][k] + ds_pre * al[r][k];
                dal[r][k] += ds_pre * f[r][k];
              }
              store_bf16<VEC>(mrow + col, mv);
            }
          }
        }
      }
      if (head_ok && sub == 0) der[vh] = der_acc;
    }

    if (!head_ok) continue;
    float* prow = dal_part + static_cast<int64_t>(warp) * hd + h * D;
#pragma unroll
    for (int r = 0; r < REPS; ++r) {
      const int col = (r * lanes + sub) * VEC;
      if (col < D) {
#pragma unroll
        for (int k = 0; k < VEC; ++k) prow[col + k] = dal[r][k];
      }
    }
  }
}

struct Geometry {
  int vec, lanes, reps;
};

constexpr int kMaxReps = 4;

// the lane layout for per-head width d (see the note at the top); vec also
// divides the alignment of every base pointer it is used with. reps == 0
// marks a width the kernels do not take.
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
    float m = -CUDART_INF_F;  // this lane's running max and sum
    float den = 0.f;
    if (head_ok) {
      for (int e = start + slot; e < end; e += per) {
        const float s = scores[static_cast<int64_t>(e) * H + h];
        if (s > m) {
          den *= expf(m - s);
          m = s;
        }
        den += expf(s - m);
      }
    }
    // merge the lanes of one head; a lane that saw no edge has (-inf, 0)
    for (int off = 16; off >= G; off >>= 1) {
      const float m_o = __shfl_xor_sync(kFull, m, off);
      const float den_o = __shfl_xor_sync(kFull, den, off);
      const float m_new = fmaxf(m, m_o);
      den = (m == -CUDART_INF_F ? 0.f : den * expf(m - m_new)) +
            (m_o == -CUDART_INF_F ? 0.f : den_o * expf(m_o - m_new));
      m = m_new;
    }
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
// edge order); dal_part f32 [n_blocks * 8, H, D], one partial per warp
int gat_bwd(const void* indptr, const void* src_of, const void* feat, const void* el,
            const void* er, const void* keep, float inv_keep, float slope, const void* smax,
            const void* denom, const void* dout, const void* attn_l, void* der, void* msg,
            void* dal_part, int n_rows, int H, int D, int n_blocks, void* stream) {
  if (n_rows <= 0 || H <= 0 || D <= 0 || n_blocks <= 0)
    return static_cast<int>(cudaGetLastError());
  const uintptr_t align = reinterpret_cast<uintptr_t>(feat) | reinterpret_cast<uintptr_t>(msg);
  const Geometry geo = geometry(D, align);
  const dim3 grid(n_blocks), block(kWarps * 32);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define BWD_CASE(V, R)                                                                   \
  case V * 16 + R:                                                                      \
    gat_bwd_kernel<V, R><<<grid, block, 0, st>>>(                                       \
        static_cast<const int32_t*>(indptr), static_cast<const int32_t*>(src_of),       \
        static_cast<const __nv_bfloat16*>(feat), static_cast<const float*>(el),         \
        static_cast<const __nv_bfloat16*>(er), static_cast<const uint8_t*>(keep),       \
        inv_keep, slope, static_cast<const float*>(smax), static_cast<const float*>(denom), \
        static_cast<const float*>(dout), static_cast<const __nv_bfloat16*>(attn_l),     \
        static_cast<float*>(der), static_cast<__nv_bfloat16*>(msg),                     \
        static_cast<float*>(dal_part), n_rows, H, D, geo.lanes);                        \
    break;
  switch (geo.vec * 16 + geo.reps) {
    GAT_CASES(BWD_CASE)
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
#undef BWD_CASE
  return static_cast<int>(cudaGetLastError());
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
