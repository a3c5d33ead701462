// GAT attention for Hopper (sm_90a) on the CSC: the per-node prep, the fused
// attention forward and backward, and the standalone segment softmax and its
// backward.
//
// Replaces glnn_tpu/ops/gat_pallas.py:_gat_fwd_kernel (:158) and
// :_gat_bwd_kernel (:187). Those run in AttentionPlan slot space: per dst
// block they form the scores with a block-diagonal attn_l matmul, pick er per
// slot with a one-hot matmul, subtract the block's score max, and broadcast
// per-head weights over features with a replication matrix, all because the
// TPU's only fast reduction is the MXU. None of that carries over. Here the
// edges are dst-sorted, one warp walks a dst row v's in-edges
// indptr[v]:indptr[v+1], and the per-node scalars el and er make each score
// s = leaky_relu(el[src,h] + er[v,h]) a two-load affair.
//
// Prep (gat_prep). One pass over the f32 features [N, H, D] writes the bf16
// features, el[u,h] = sum_j bf16(feat[u,h,j]) bf16(attn_l[h,j]) in f32 (the
// TPU kernel's score matmul, gat_pallas.py:118, with its rounding, but once
// per node: the TPU kernel computes it per slot in its body) and
// er[v,h] = bf16(sum_j feat[v,h,j] attn_r[h,j] in f32) (one rounding, as
// _prep at :409-420). Lanes lie across (row of D, column group) with 16-byte
// loads, so a warp reads consecutive rows as one run; el and er are summed
// over a row's lanes with shuffles. Folding el into gat_fwd per edge, as the
// TPU kernel does, would gather every feature row twice under a max-first
// softmax; a per-node el costs one [N, H] f32 array. Bound: bytes (the f32
// features read once, the bf16 features written once).
//
// Dropout (both GAT kernels). A keep bit per (dst-sorted edge e, head h):
// either from a uint8 [E, H] mask (the JAX "mask" mode, gat_pallas.py:149),
// or generated in the kernel from a 64-bit seed read through a device
// pointer with Philox4x32-10 (Random123's constants): key (seed lo, seed
// hi), counter (edge_base + e, h >> 2, 0, 0) (uint32, wrapping), word h & 3,
// kept iff word < thresh, with thresh = min(keep * 2^32, 2^32 - 1) as
// _drop_spec_arg (:312) forms it. edge_base is 0 on one device; a shard of
// a halo-sharded graph passes the global id of its first edge, so that its
// keep bits are the single-device bits of the same global edges. The
// TPU kernel draws from its hardware PRNG (:152), which no other machine
// reproduces; the seed mode is its counterpart and makes no [E, H] tensor.
// The keep bits of an edge for the heads of a pass are one word (bit i for
// head h0 + i), formed once per edge and 4-head block, not once per lane:
// in gat_bwd by the lane that loads the edge's source index in its 32-edge
// chunk, which hands the word out with the index through __shfl_sync; in
// gat_fwd by as many neighbouring lanes as the edge spans 4-head blocks
// (one Philox call each), into shared memory beside the edge's terms. A
// kept edge's weight is inv_keep, a dropped one's 0, and without dropout
// every weight is 1.
//
// Lane layout of the feature walks: D = per-head width, H = heads. A lane
// holds VEC consecutive features (VEC the largest power of two <= 8 dividing
// D: one load of up to 16 bytes), REPS such groups strided by LH * VEC, all
// in one head. LH = ceil(D / VEC / REPS) lanes cover a head (not a power of
// two: (1, 40) gives 5), HP heads an edge, and SLOTS = 32 / (HP * LH) edges
// are walked at once ((8, 16): 16 lanes per edge, 2 slots; (1, 40): 5 lanes
// per edge, 6 slots in gat_bwd, and 10 lanes of 8-byte loads, 3 slots, in
// gat_fwd, whose folds cost more per slot); per-slot sums fold onto slot 0
// with __shfl_down_sync at the row's end. The caller works the geometry out
// (ops/gat_cuda.py `fwd_geometry`, `bwd_geometry`) and the kernels check
// it. Enough blocks to fill every SM once (the caller asks the occupancy
// of the instantiation) stride over the rows.
//
// Forward (gat_fwd). Per dst row and pass of up to 8 heads, a 32-edge chunk
// at a time, the scores lie across lanes by edge: lane j loads chunk edge
// j's source index and el[src, h0:h0+HP] (4 bytes per edge and head; el of
// ogbn-arxiv's size stays in the 50 MB L2), so a chunk's scores cost one
// round trip, not one per edge. Pass 1 takes each head's segment max across
// the lanes (__shfl_xor_sync); pass 2 forms each term once with that final
// max, p = exp(s - max), and the edge's keep bits, and leaves them in shared
// memory (with the row's er and max: per-head values stay out of
// registers); the feature layout then sums den += p (the UNDROPPED weights,
// dgl GATConv semantics) and acc += p w f over the bf16 feature slices in
// f32 per slot (a dropped edge's row is not read), and slot 0 writes
// out = acc * (1 / den): one reciprocal per (row, head), and den >= 1 (the
// max term is exp(0)), so the fast reciprocal is safe. No running max is
// rescaled, so no branch diverges across heads and hub rows keep their
// accuracy (an online rescaling cost the softmax kernel its tolerance on a
// 20,000-edge row). The segment's own max is subtracted, so no segment
// underflows, unlike the TPU kernel's block max (:35-42). The first
// chunk's scores stay in shared memory between the passes; later chunks
// (rows of more than 32 edges) load el again. A row with no in-edges
// writes zeros (and max 0, den 0). The per-dst max and den [N, H] are
// written for the backward. Bound: bytes (the bf16 features, el, er and
// the indices read once, out, max and den written once). It runs far from
// that bound: each row's score stage (el loads, two butterflies, the
// exponentials and Philox) runs on 32 lanes for a mean of 15 edges;
// tools/sweep_cuda_kernels.py (`gat_fwd_parts`) times the score stage and
// the feature walk apart.
//
// Hub rows in gat_fwd (as in spmm_csr.cu, the counterpart of the tiled TPU
// kernel's bounded grid steps): a row of more than T edges would be walked
// twice by one warp while the others have finished, so it is cut into
// T-edge chunks, listed once per CSR by the caller (ops/spmm_cuda.py
// hub_plan). gat_fwd_max_kernel, launched first, takes each chunk's
// per-head max of s (a max is exact in any order). In gat_fwd_kernel the
// chunks are the first work items: a chunk warp takes its row's max M over
// the chunks' maxima, forms every term p = exp(s - M) with that final max
// as a row warp does (no running max is rescaled), and writes its sums of p
// [H] and p w f [H, D] unnormalised; a row warp leaves a row of more than
// T edges to its chunks. gat_fwd_combine_kernel sums each split row's
// partials in chunk order and writes den, the max and out = acc * (1 /
// den) (den >= 1 still: the max edge's chunk holds exp(0)). The keep bits
// stay Philox of edge_base + e, so chunking leaves them as they are; out,
// max and den keep their meaning for gat_bwd. No atomics, so two launches
// are bit-equal; a row of at most T edges is walked by one warp, as any row
// of a CSR without hub rows. gat_fwd_kernel is built with and without the
// chunk items (HUB), and a CSR without such rows takes the one launch of the
// instantiation without: kept in the same instantiation, the chunk state
// spilled at 48 registers, and without spills still cost (1, 40) 7.5% of its
// eager synth-graph time (tools/sweep_cuda_kernels.py); built apart, the
// synth-graph device times are within 1% of the kernel without any chunk
// code (tools/hub_kernel_times.py; both on an H100 80GB HBM3 at 700 W).
// T is a launch argument. The GAT layer keeps a plan of its own for
// gat_fwd and gat_bwd (ops/gat_cuda.py GAT_CHUNK = 128; the template
// body's T is 512): on the hub graph the two kernels' step is fastest at
// T = 128 at both GAT shapes. gat_fwd takes 0.465 / 0.247 ms at (8, 16) /
// (1, 40) there, 0.446 / 0.237 at T = 256 and 0.507 / 0.236 at 512, and
// gat_bwd gains 9% over 256 and 22-24% over 512 (device ms,
// tools/sweep_cuda_kernels.py --kernels gat_fwd_hub,gat_bwd_hub; H100
// 80GB HBM3, 700 W).
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
// (gat_pallas.py:237-239). Each warp keeps its own dattn_l partial, which
// the caller sums: no atomics, a deterministic result. The message, in
// dst-sorted edge order, is reduced over sources by the CSR SpMM kernel
// (spmm_csr.cu) over the transposed CSR, as _fused_bwd does with
// segment_reduce (gat_pallas.py:494). der and dattn_l could be written as
// differences of row sums (sum c w g - t sum c, c = alpha leaky_relu'),
// which would spare pass 2 the feature reads; where the attention is
// concentrated and dout is large those differences cancel more than the
// per-edge sum does (more than tenfold in tests/test_torch_kernel_design.py),
// so ds_pre stays per edge. Its largest term is the [E, H*D] bf16 message
// write (about 650 MB at E = 2.5M, H*D = 128). Pass 1 keeps (alpha, w, w g,
// the leaky_relu' factor) of the row's first K edges in shared memory
// (K = 4 KB per warp / (16 bytes * HP)); pass 2 takes those terms from the
// cache and reads the edge's feature slice again for dattn_l (the row was
// just gathered by the same warp), and attn_l from L1; only edges past K
// load el and recompute alpha and g. Both passes regenerate the keep bits.
//
// Hub rows in gat_bwd (the counterpart of the bounded work per dst block of
// gat_pallas._gat_bwd_kernel; past X_MAX, of JAX's XLA tier): a row of more
// than T edges is cut into the CSR's hub-plan chunks, as in gat_fwd, but
// every edge's ds_pre = c alpha (w g - t) needs its row's t = sum alpha w g
// before pass 2, so no chunk can finish alone. gat_bwd_kernel is built
// three ways (BwdItems): kRows, the kernel as it was, for a CSR without
// hub rows; kChunkT, launched first, one warp per chunk running pass 1
// alone (no cache) and writing the chunk's part of t (pt, folded over the
// slots as a row's t is); and kSplit, the chunks first in the grid, each
// taking its row's t as the sum of the row's pt in chunk order from zero
// (every chunk warp of a row the same sum, so the same t) and running
// pass 2 over its own edges with no cache: it writes their messages (one
// chunk per edge, so no combine), adds to its warp's dattn_l partial as a
// row does, and writes its part of der (pder); then the rows of at most T
// edges. gat_bwd_combine_kernel sums each split row's pder in chunk order
// into der. ds_pre stays per edge (der as a difference of row sums
// cancels, above). alpha needs the row's final max and den, which gat_fwd
// (or its combine) saved, so it is the same in every chunk. No atomics:
// the dattn_l partials are per warp of one grid (the kSplit
// instantiation's occupancy), so two launches are bit-equal.
//
// The standalone segment softmax (edge_softmax_fwd, edge_softmax_bwd)
// replaces :_smx_fwd_kernel (:694) and :_smx_bwd_kernel (:712), which run
// the same one-hot slot-space reduction per dst block. Here scores are f32
// [E, H] in dst-sorted edge order, so a dst row's scores are one contiguous
// run of (end - start) * H floats. Lanes cover (edge, head) pairs: G lanes
// per edge (G the smallest power of two >= H, at most 32, more heads in
// further passes). The forward splits a warp into 32 / (G P) groups of P
// edge slots, one group per consecutive row; a row of at most P R edges
// (R = 8; the caller picks P, ops/gat_cuda.py `softmax_geometry`, so that
// rows up to twice the mean in-degree fit) is read once into R registers
// per lane, its max and sum taken with __shfl_xor_sync inside the group,
// and alpha written from the registers. A longer row is walked afterwards
// by the whole warp: the segment max first, then a compensated (Kahan) sum
// of exp(s - max), since a plain f32 sum of a 20,000-edge segment's
// exponentials is off by about 1e-5 of itself, then alpha = exp(s - max) /
// sum. Every term is formed with the segment's own final max (the TPU
// kernel subtracts its block's, gat_pallas.py:700). The backward sums
// t = sum_seg(alpha * dalpha) and writes ds = alpha * dalpha - alpha * t,
// one warp per row (g lanes per edge, 32 / g edges a step, each lane's
// plain f32 sum of its edges in order, the lanes' sums by __shfl_xor_sync).
// A row without in-edges writes nothing. Both are bound by bytes (each
// reads its [E, H] inputs once and writes [E, H] once; a few flops per
// element): the backward's bound is alpha and dalpha read once and ds
// written once, 12 bytes per element.
//
// Hub rows in the forward (the counterpart of _smx_fwd_kernel's bounded
// work per dst block): a row of more than T edges is cut into the hub
// plan's chunks, one warp each, in three launches as gat_fwd's:
// edge_softmax_hub_max_kernel takes each chunk's max per head;
// edge_softmax_hub_sum_kernel each chunk's compensated sum of exp(s - M),
// M its row's final max (the largest chunk max: exact in any order); then
// edge_softmax_fwd_kernel<true>, whose first warps write each chunk's
// alpha = exp(s - M) / den, den the row's chunk sums added in chunk order
// from zero, and whose row groups leave those rows to them (rows of at
// most T edges as before: registers or the whole warp). A chunk warp's
// lane keeps kSmxInFlight scores loaded before it uses the first, since
// one dependent load at a time is what held a 20,000-edge row to one
// warp's latency. The same lanes, edge order and compensated sums as a
// long row's walk, so a chunk's sum is that walk's over its edges.
//
// Hub rows in the backward (the counterpart of the bounded work per dst
// block of gat_pallas._smx_bwd_kernel, :712; past X_MAX, of JAX's XLA
// tier, which a mega-hub's block goes to): every ds of a row needs the
// row's t, so a row of more than T edges is cut into the hub plan's chunks
// in two launches. edge_softmax_bwd_hub_t_kernel, launched first, one warp
// per chunk with a row warp's lanes, writes the chunk's part of t (pt
// [n_chunks, H], its lanes' sums folded as a row's are), kSmxInFlight
// alpha and dalpha loaded before the first product is taken. Then
// edge_softmax_bwd_kernel<true>, whose first warps take their row's t as
// the sum of its chunks' pt in chunk order from zero (every chunk warp of
// a row the same sum, so the same t) and write ds over their own edges:
// ds is per edge, so no third launch combines anything. Its row warps
// leave the rows of more than T edges to them. No atomics, so two launches
// are bit-equal. edge_softmax_bwd_kernel<false>, the kernel without chunk
// items, is the only launch on a CSR without such rows, so the chunk state
// costs those graphs nothing (as gat_fwd's and the forward's HUB
// instantiations).
//
// Interface: plain C, called through ctypes. Every entry point launches on
// the given stream, never synchronises, allocates nothing, and returns
// cudaGetLastError() (or cudaErrorInvalidValue for a shape or geometry it
// does not take).

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

// VEC f32 values in one load of VEC * 4 bytes
template <int VEC>
__device__ __forceinline__ void load_f32(const float* p, float* out) {
  if constexpr (VEC == 1) {
    out[0] = *p;
  } else if constexpr (VEC == 2) {
    const float2 v = *reinterpret_cast<const float2*>(p);
    out[0] = v.x;
    out[1] = v.y;
  } else {
    const float4 v = *reinterpret_cast<const float4*>(p);
    out[0] = v.x;
    out[1] = v.y;
    out[2] = v.z;
    out[3] = v.w;
  }
}

__device__ __forceinline__ float leaky(float x, float slope) {
  return x >= 0.f ? x : slope * x;
}

// ---- dropout ---------------------------------------------------------------

constexpr uint32_t kPhiloxM0 = 0xD2511F53u, kPhiloxM1 = 0xCD9E8D57u;
constexpr uint32_t kPhiloxW0 = 0x9E3779B9u, kPhiloxW1 = 0xBB67AE85u;

// Philox4x32-10 of counter c under key (k0, k1)
__device__ __forceinline__ uint4 philox(uint4 c, uint32_t k0, uint32_t k1) {
#pragma unroll
  for (int i = 0; i < 10; ++i) {
    if (i) {
      k0 += kPhiloxW0;
      k1 += kPhiloxW1;
    }
    const uint32_t hi0 = __umulhi(kPhiloxM0, c.x), lo0 = kPhiloxM0 * c.x;
    const uint32_t hi1 = __umulhi(kPhiloxM1, c.z), lo1 = kPhiloxM1 * c.z;
    c = make_uint4(hi1 ^ c.y ^ k0, lo1, hi0 ^ c.w ^ k1, lo0);
  }
  return c;
}

// what the caller passes: a keep mask or a seed (never both), or neither
struct DropArgs {
  const uint8_t* mask;                // uint8 [E, H], or null
  const unsigned long long* seed;     // one 64-bit seed on the device, or null
  unsigned thresh;                    // seed mode: keep iff word < thresh
  unsigned edge_base;                 // seed mode: counter of edge e is edge_base + e
  float inv_keep;                     // a kept edge's weight
};

// the same, with the seed read once per thread
struct Drop {
  const uint8_t* mask;
  bool seeded;
  uint32_t k0, k1, thresh, base;
  float inv_keep;
};

__device__ __forceinline__ Drop make_drop(const DropArgs& a) {
  // without dropout every weight is 1, whatever inv_keep says
  Drop d{a.mask, a.seed != nullptr, 0u, 0u, a.thresh, a.edge_base,
         a.mask != nullptr || a.seed != nullptr ? a.inv_keep : 1.f};
  if (d.seeded) {
    const unsigned long long s = *a.seed;
    d.k0 = static_cast<uint32_t>(s);
    d.k1 = static_cast<uint32_t>(s >> 32);
  }
  return d;
}

// keep bits of edge e for heads h0 .. h0 + hp - 1 (bit i for head h0 + i);
// every bit set without dropout
__device__ __forceinline__ unsigned keep_bits(const Drop& d, int64_t e, int H, int h0,
                                              int hp) {
  const int hn = min(hp, H - h0);
  unsigned bits = 0;
  if (d.mask != nullptr) {
    const uint8_t* row = d.mask + e * H + h0;
    for (int i = 0; i < hn; ++i) bits |= (row[i] ? 1u : 0u) << i;
    return bits;
  }
  if (!d.seeded) return kFull;
  uint4 w = make_uint4(0u, 0u, 0u, 0u);
  for (int i = 0; i < hn; ++i) {
    const int h = h0 + i;
    if (i == 0 || (h & 3) == 0)
      w = philox(make_uint4(d.base + static_cast<uint32_t>(e), static_cast<uint32_t>(h >> 2),
                            0u, 0u),
                 d.k0, d.k1);
    const int k = h & 3;
    const uint32_t word = k == 0 ? w.x : k == 1 ? w.y : k == 2 ? w.z : w.w;
    bits |= (word < d.thresh ? 1u : 0u) << i;
  }
  return bits;
}

// the keep bits of the n edges e0 .. e0 + n - 1 for heads h0 .. h0 + hn - 1
// into bits[0 .. n) (bit i for head h0 + i). In seed mode the G 4-head
// blocks an edge spans go to G neighbouring lanes, one Philox call each,
// whose bits an OR over the G lanes joins: a chunk of at most 32 / G edges
// takes one call per lane, where one lane per edge would take G. Every lane
// of the warp must call it.
__device__ __forceinline__ void chunk_keep_bits(const Drop& d, int64_t e0, int n, int H, int h0,
                                                int hn, unsigned* bits) {
  const int lane = threadIdx.x & 31;
  if (!d.seeded) {
    if (lane < n) bits[lane] = keep_bits(d, e0 + lane, H, h0, hn);
    return;
  }
  const int b0 = h0 >> 2;
  const int g = ((h0 + hn - 1) >> 2) - b0 + 1;  // blocks spanned, <= 3 for hn <= 8
  const int per = 32 / g;                       // edges per round
  const int j0 = lane / g, c = lane - j0 * g;
  for (int r = 0; r < n; r += per) {  // warp-uniform
    const int j = r + j0;
    unsigned part = 0;
    if (j0 < per && j < n) {
      const int blk = b0 + c;
      const uint4 w =
          philox(make_uint4(d.base + static_cast<uint32_t>(e0 + j), static_cast<uint32_t>(blk),
                            0u, 0u),
                 d.k0, d.k1);
      const uint32_t words[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int i = 4 * blk + k - h0;  // bit of head 4 blk + k
        if (i >= 0 && i < hn) part |= (words[k] < d.thresh ? 1u : 0u) << i;
      }
    }
    for (int off = 1; off < g; ++off) {
      const unsigned o = __shfl_down_sync(kFull, part, off);
      if (c + off < g) part |= o;
    }
    if (c == 0 && j0 < per && j < n) bits[j] = part;
  }
}

// ---- shared pieces of the GAT kernels -------------------------------------

// sum over the lh lanes of a group (lh need not be a power of two), whose
// first lane is lane - sub; every lane of the warp must call it and gets its
// group's sum
__device__ __forceinline__ float head_sum(float v, int sub, int lh) {
  for (int off = 1; off < lh; off <<= 1) {
    const float o = __shfl_down_sync(kFull, v, off);
    if (sub + off < lh) v += o;
  }
  return __shfl_sync(kFull, v, (threadIdx.x & 31) - sub);
}

struct Add {
  __device__ __forceinline__ float operator()(float a, float b) const { return a + b; }
};
struct Max {
  __device__ __forceinline__ float operator()(float a, float b) const { return fmaxf(a, b); }
};

// fold the per-slot values of `slots` slots of `le` lanes each onto slot 0
// (slots [h, s) onto [0, s - h)); every lane of the warp must call it
template <class Op = Add>
__device__ __forceinline__ float slot_fold(float v, int q, int slots, int le, Op op = Op()) {
  for (int s = slots; s > 1;) {
    const int h = (s + 1) >> 1;
    const float o = __shfl_down_sync(kFull, v, h * le);
    if (q + h < s) v = op(v, o);
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

// the lane's place in the (edge slot, head, column group) layout
struct Lanes {
  int le;    // lanes per edge
  int q;     // edge slot
  int hh;    // head of the pass
  int sub;   // column group within the head
};

__device__ __forceinline__ Lanes lanes_of(int lane, int lh, int hp) {
  Lanes l;
  l.le = hp * lh;
  l.q = lane / l.le;
  l.hh = (lane - l.q * l.le) / lh;
  l.sub = lane - l.q * l.le - l.hh * lh;
  return l;
}

// bit r: the lane's column group r lies in its head
template <int VEC, int REPS>
__device__ __forceinline__ unsigned col_bits(bool lane_ok, int lh, int sub, int D) {
  unsigned cols = 0;
#pragma unroll
  for (int r = 0; r < REPS; ++r) cols |= (lane_ok && (r * lh + sub) * VEC < D ? 1u : 0u) << r;
  return cols;
}

// ---- prep ------------------------------------------------------------------

// rows = N * H rows of D f32 features; lr lanes per row, 32 / lr rows per
// warp step, REPS groups of VEC columns per lane
template <int VEC, int REPS>
__global__ void __launch_bounds__(kWarps * 32)
gat_prep_kernel(const float* __restrict__ feat, const float* __restrict__ attn_l,
                const float* __restrict__ attn_r, __nv_bfloat16* __restrict__ feat_b,
                float* __restrict__ el, __nv_bfloat16* __restrict__ er, int64_t rows, int H,
                int D, int lr) {
  const int lane = threadIdx.x & 31;
  const int warp = blockIdx.x * kWarps + (threadIdx.x >> 5);
  const int n_warps = gridDim.x * kWarps;
  const int rpw = 32 / lr;
  const int q = lane / lr;
  const int sub = lane - q * lr;
  for (int64_t r0 = static_cast<int64_t>(warp) * rpw; r0 < rows;
       r0 += static_cast<int64_t>(n_warps) * rpw) {  // warp-uniform
    const int64_t r = r0 + q;
    const bool ok = q < rpw && r < rows;
    const int h = ok ? static_cast<int>(r % H) : 0;
    float sl = 0.f, sr = 0.f;
#pragma unroll
    for (int rep = 0; rep < REPS; ++rep) {
      const int col = (rep * lr + sub) * VEC;
      if (ok && col < D) {
        float f[VEC], al[VEC], ar[VEC], fb[VEC];
        load_f32<VEC>(feat + r * D + col, f);
        load_f32<VEC>(attn_l + h * D + col, al);
        load_f32<VEC>(attn_r + h * D + col, ar);
#pragma unroll
        for (int k = 0; k < VEC; ++k) {
          fb[k] = __bfloat162float(__float2bfloat16(f[k]));
          sl += fb[k] * __bfloat162float(__float2bfloat16(al[k]));
          sr += f[k] * ar[k];
        }
        store_bf16<VEC>(feat_b + r * D + col, fb);
      }
    }
    sl = head_sum(sl, sub, lr);
    sr = head_sum(sr, sub, lr);
    if (ok && sub == 0) {
      el[r] = sl;
      er[r] = __float2bfloat16(sr);
    }
  }
}

struct PrepGeometry {
  int vec, reps, lr;
};

constexpr int kPrepMaxReps = 8;

// the prep's lane layout for rows of d f32 values whose base addresses are
// aligned to `align` bytes; reps == 0 marks a width it does not take
PrepGeometry prep_geometry(int d, uintptr_t align) {
  int vec = 4;
  while (vec > 1 && (d % vec != 0 || align % (vec * sizeof(float)) != 0)) vec /= 2;
  const int groups = d / vec;
  int reps = 1;
  while (reps * 32 < groups) reps *= 2;
  return {vec, reps <= kPrepMaxReps ? reps : 0, (groups + reps - 1) / reps};
}

#define PREP_CASES(X) \
  X(1, 1) X(1, 2) X(1, 4) X(1, 8) X(2, 1) X(2, 2) X(2, 4) X(2, 8) X(4, 1) X(4, 2) X(4, 4) X(4, 8)

// ---- the fused attention ---------------------------------------------------

constexpr int kFwdMaxHeads = 8;  // heads of a gat_fwd pass (NH)

// gat_fwd's hub rows (see the note at the top): the plan of the CSR
// (ops/spmm_cuda.py hub_plan) and the partials of its chunks
struct HubArgs {
  const int2* chunks;     // [n_chunks]: each chunk's edge range
  const int32_t* owner;   // [n_chunks]: each chunk's split row s
  const int32_t* rows;    // [n_split]: the split rows
  const int32_t* first;   // [n_split + 1]: row s's chunks are first[s]:first[s + 1]
  float* pmax;            // [n_chunks, H]: each chunk's segment max
  float* pden;            // [n_chunks, H]: each chunk's sum of p
  float* pacc;            // [n_chunks, H, D]: each chunk's sum of p w f
  int n_chunks;
  int chunk_edges;        // T: the row warps leave longer rows to the chunks
};

// per warp: the scores, then the terms p, of the edges of its chunk
// [32][NH]; the chunk edges' keep bits; the row's er and segment max for
// the heads of the pass
template <int NH>
struct FwdScratch {
  float term[32 * NH];
  unsigned bits[32];
  float er[NH], max[NH];
};

// Scores lie across lanes by edge (lane j holds chunk edge j's NH heads of
// the pass); features across (edge slot, head, column group). At most 8
// columns per lane, ptxas left to itself trims some of these
// instantiations to an occupancy target by spilling; asking resident
// blocks per SM gives it a register budget that needs no spill: 5 blocks
// (48 registers) for one load per lane, 4 (64) for several, which spill
// under 48.
template <int VEC, int REPS, int NH, bool HUB>
__global__ void __launch_bounds__(kWarps * 32, VEC * REPS <= 8 ? (REPS == 1 ? 5 : 4) : 1)
gat_fwd_kernel(const int32_t* __restrict__ indptr, const int32_t* __restrict__ src_of,
               const __nv_bfloat16* __restrict__ feat, const float* __restrict__ el,
               const __nv_bfloat16* __restrict__ er, DropArgs drop_args, float slope,
               float* __restrict__ out, float* __restrict__ smax, float* __restrict__ denom,
               const HubArgs hub, int n_rows, int H, int D, int lh, int hp, int slots) {
  __shared__ FwdScratch<NH> scratch[kWarps];
  const int lane = threadIdx.x & 31;
  const int warp = blockIdx.x * kWarps + (threadIdx.x >> 5);
  const int n_warps = gridDim.x * kWarps;
  FwdScratch<NH>& sc = scratch[threadIdx.x >> 5];
  const Drop drop = make_drop(drop_args);
  const int hd = H * D;
  const Lanes L = lanes_of(lane, lh, hp);

  // work items: with HUB, the hub chunks first (item < n_chunks: an edge
  // range of a split row, whose partials go to pden and pacc), then the
  // rows (item - n_chunks, unless it has more than chunk_edges edges);
  // without (a plan without chunks), the rows. Only item, start and end
  // stay live across a pass (more spills at 48 registers): whatever else a
  // chunk needs is loaded where it is used
  const int n_chunks = HUB ? hub.n_chunks : 0;
  for (int item = warp; item < n_chunks + n_rows; item += n_warps) {  // warp-uniform
    int start, end;
    if (HUB && item < n_chunks) {
      const int2 c = hub.chunks[item];
      start = c.x;
      end = c.y;
    } else {
      start = indptr[item - n_chunks];
      end = indptr[item - n_chunks + 1];
      if (HUB && end - start > hub.chunk_edges) continue;  // its chunks walk it
    }
    for (int h0 = 0; h0 < H; h0 += hp) {  // one pass unless H > hp
      const int hn = min(hp, H - h0);     // heads of the pass
      const int h = h0 + L.hh;
      const bool lane_ok = L.q < slots && L.hh < hn;
      const unsigned cols = col_bits<VEC, REPS>(lane_ok, lh, L.sub, D);
      if (start == end) {  // no in-edges: zeros (a chunk is never empty)
        const int64_t row = item - n_chunks;
        const int64_t vh = row * H + h;
        float* orow = out + row * hd + h * D;
        if (L.q == 0 && lane_ok) {
#pragma unroll
          for (int r = 0; r < REPS; ++r)
            if (cols >> r & 1u)
#pragma unroll
              for (int k = 0; k < VEC; ++k) orow[(r * lh + L.sub) * VEC + k] = 0.f;
          if (L.sub == 0) {
            smax[vh] = 0.f;
            denom[vh] = 0.f;
          }
        }
        continue;
      }
      if (lane < hn) {
        const int64_t row =
            HUB && item < n_chunks ? hub.rows[hub.owner[item]] : item - n_chunks;
        sc.er[lane] = __bfloat162float(er[row * H + h0 + lane]);
      }
      __syncwarp();

      // pass 1: lane j scores chunk edge j for every head of the pass (the
      // first chunk's scores stay in scratch); the segment max per head
      // over the lanes. A hub chunk scores only its first 32 edges here and
      // takes its row's max over the chunks' maxima (gat_fwd_max_kernel)
      {
        const int scan_end = HUB && item < n_chunks ? min(end, start + 32) : end;
        float m[NH];
#pragma unroll
        for (int i = 0; i < NH; ++i) m[i] = -CUDART_INF_F;
        for (int e = start + lane; e - lane < scan_end; e += 32) {  // warp-uniform
          if (e < scan_end) {
            const float* elrow = el + static_cast<int64_t>(src_of[e]) * H + h0;
#pragma unroll
            for (int i = 0; i < NH; ++i)
              if (i < hn) {
                const float s = leaky(elrow[i] + sc.er[i], slope);
                m[i] = fmaxf(m[i], s);
                if (e - lane == start) sc.term[lane * NH + i] = s;
              }
          }
        }
#pragma unroll
        for (int i = 0; i < NH; ++i) {
#pragma unroll
          for (int off = 16; off > 0; off >>= 1)
            m[i] = fmaxf(m[i], __shfl_xor_sync(kFull, m[i], off));
          if (lane == i) sc.max[i] = m[i];
        }
        if (HUB && item < n_chunks && lane < hn) {  // a max is exact in any order
          const int split = hub.owner[item];
          float mm = -CUDART_INF_F;
          for (int k = hub.first[split]; k < hub.first[split + 1]; ++k)
            mm = fmaxf(mm, hub.pmax[static_cast<int64_t>(k) * H + h0 + lane]);
          sc.max[lane] = mm;
        }
      }
      __syncwarp();

      // pass 2, per chunk: lane j forms its edge's terms once with the
      // final max, and its keep bits; then the feature lanes sum p (the
      // denominator) and p w f, per slot
      float den = 0.f;
      float acc[REPS][VEC];
#pragma unroll
      for (int r = 0; r < REPS; ++r)
#pragma unroll
        for (int k = 0; k < VEC; ++k) acc[r][k] = 0.f;
      for (int e0 = start; e0 < end; e0 += 32) {
        const int n = min(32, end - e0);
        const int mine = lane < n ? src_of[e0 + lane] : 0;
        if (lane < n) {
          const float* elrow = el + static_cast<int64_t>(mine) * H + h0;
#pragma unroll
          for (int i = 0; i < NH; ++i)
            if (i < hn) {
              const float s = e0 == start ? sc.term[lane * NH + i]
                                          : leaky(elrow[i] + sc.er[i], slope);
              sc.term[lane * NH + i] = expf(s - sc.max[i]);
            }
        }
        chunk_keep_bits(drop, e0, n, H, h0, hn, sc.bits);
        __syncwarp();  // the terms written above are read by other lanes below
        const int steps = (n + slots - 1) / slots;  // warp-uniform
#pragma unroll 4
        for (int j = 0; j < steps; ++j) {
          const int k = j * slots + L.q;
          const int src = __shfl_sync(kFull, mine, k & 31);
          if (lane_ok && k < n) {
            const float p = sc.term[k * NH + L.hh];
            den += p;
            if (sc.bits[k] >> L.hh & 1u) {  // a dropped edge's row is not read
              const float pw = p * drop.inv_keep;
              float f[REPS][VEC];
              load_slice<VEC, REPS>(feat + static_cast<int64_t>(src) * hd + h * D, cols, lh,
                                    L.sub, f);
#pragma unroll
              for (int r = 0; r < REPS; ++r)
#pragma unroll
                for (int c = 0; c < VEC; ++c) acc[r][c] += pw * f[r][c];
            }
          }
        }
        __syncwarp();  // every lane is done with the terms before the next chunk
      }
      den = slot_fold(den, L.q, slots, L.le);
#pragma unroll
      for (int r = 0; r < REPS; ++r)
#pragma unroll
        for (int k = 0; k < VEC; ++k) acc[r][k] = slot_fold(acc[r][k], L.q, slots, L.le);
      if (L.q == 0 && lane_ok) {
        // a row's den >= 1 (its max term is exp(0)); a chunk's partials go
        // out as they are, and gat_fwd_combine_kernel divides
        const bool chunk = HUB && item < n_chunks;
        const int64_t at = chunk ? item : item - n_chunks;
        const float inv_den = chunk ? 1.f : __fdividef(1.f, den);
        float* orow = (chunk ? hub.pacc : out) + at * hd + h * D;
#pragma unroll
        for (int r = 0; r < REPS; ++r)
          if (cols >> r & 1u)
#pragma unroll
            for (int k = 0; k < VEC; ++k) orow[(r * lh + L.sub) * VEC + k] = acc[r][k] * inv_den;
        if (L.sub == 0) {
          if (!chunk) smax[at * H + h] = sc.max[L.hh];
          (chunk ? hub.pden : denom)[at * H + h] = den;
        }
      }
      __syncwarp();  // the scratch is read above before the next pass writes it
    }
  }
}

// Hub rows, before gat_fwd_kernel: one warp per chunk takes its chunk's
// segment max per head (lane j scores the chunk's edges j, j + 32, ...,
// with the expression gat_fwd_kernel scores them with) into pmax.
__global__ void __launch_bounds__(kWarps * 32)
gat_fwd_max_kernel(const HubArgs hub, const int32_t* __restrict__ src_of,
                   const float* __restrict__ el, const __nv_bfloat16* __restrict__ er,
                   float slope, int H) {
  const int lane = threadIdx.x & 31;
  const int c = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (c >= hub.n_chunks) return;  // the whole warp leaves together
  const int2 range = hub.chunks[c];
  const int row = hub.rows[hub.owner[c]];
  for (int h0 = 0; h0 < H; h0 += kFwdMaxHeads) {
    const int hn = min(kFwdMaxHeads, H - h0);
    float er_v[kFwdMaxHeads], m[kFwdMaxHeads];
#pragma unroll
    for (int i = 0; i < kFwdMaxHeads; ++i) {
      er_v[i] = i < hn ? __bfloat162float(er[static_cast<int64_t>(row) * H + h0 + i]) : 0.f;
      m[i] = -CUDART_INF_F;
    }
    for (int e = range.x + lane; e < range.y; e += 32) {
      const float* elrow = el + static_cast<int64_t>(src_of[e]) * H + h0;
#pragma unroll
      for (int i = 0; i < kFwdMaxHeads; ++i)
        if (i < hn) m[i] = fmaxf(m[i], leaky(elrow[i] + er_v[i], slope));
    }
#pragma unroll
    for (int i = 0; i < kFwdMaxHeads; ++i) {
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        m[i] = fmaxf(m[i], __shfl_xor_sync(kFull, m[i], off));
      if (lane == i && i < hn) hub.pmax[static_cast<int64_t>(c) * H + h0 + i] = m[i];
    }
  }
}

// Hub rows, after gat_fwd_kernel: one warp per split row s sums its chunks'
// den and p w f partials in chunk order and writes the row as gat_fwd_kernel
// writes one: out = acc * (1 / den) (den >= 1: the chunk of the max edge
// holds exp(0)), the row max (the largest chunk max) and den.
__global__ void __launch_bounds__(kWarps * 32)
gat_fwd_combine_kernel(const HubArgs hub, float* __restrict__ out, float* __restrict__ smax,
                       float* __restrict__ denom, int n_split, int H, int D) {
  const int lane = threadIdx.x & 31;
  const int s = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (s >= n_split) return;
  const int64_t row = hub.rows[s];
  const int k0 = hub.first[s], k1 = hub.first[s + 1];
  const int hd = H * D;
  for (int h = lane; h < H; h += 32) {
    float m = -CUDART_INF_F, den = 0.f;
    for (int k = k0; k < k1; ++k) {
      m = fmaxf(m, hub.pmax[static_cast<int64_t>(k) * H + h]);
      den += hub.pden[static_cast<int64_t>(k) * H + h];
    }
    smax[row * H + h] = m;
    denom[row * H + h] = den;
  }
  for (int col = lane; col < hd; col += 32) {
    const int h = col / D;
    float den = 0.f, acc = 0.f;  // den summed as above, so the same bits
    for (int k = k0; k < k1; ++k) {
      den += hub.pden[static_cast<int64_t>(k) * H + h];
      acc += hub.pacc[static_cast<int64_t>(k) * hd + col];
    }
    out[row * hd + col] = acc * __fdividef(1.f, den);
  }
}

// per-edge quantities of the backward, recomputed from the forward's inputs
struct EdgeTerms {
  float s_pre;  // el + er, before leaky_relu
  float alpha;  // exp(s - max) / den
};

__device__ __forceinline__ EdgeTerms edge_terms(float el_src, float er_v, float m_v,
                                                float inv_den, float slope) {
  EdgeTerms t;
  t.s_pre = el_src + er_v;
  t.alpha = expf(leaky(t.s_pre, slope) - m_v) * inv_den;
  return t;
}

// gat_bwd's hub rows (see the note at the top): the plan of the CSR
// (ops/spmm_cuda.py hub_plan) and the partials of its chunks
struct BwdHub {
  const int2* chunks;     // [n_chunks]: each chunk's edge range
  const int32_t* owner;   // [n_chunks]: each chunk's split row s
  const int32_t* rows;    // [n_split]: the split rows
  const int32_t* first;   // [n_split + 1]: row s's chunks are first[s]:first[s + 1]
  float* pt;              // [n_chunks, H]: each chunk's sum of alpha w g
  float* pder;            // [n_chunks, H]: each chunk's sum of ds_pre
  int n_chunks;
  int chunk_edges;        // T: the row items leave longer rows to the chunks
};

// the work items of a launch of gat_bwd_kernel
enum class BwdItems {
  kRows,    // every row (a CSR without hub rows)
  kChunkT,  // each hub chunk's pass 1 alone: its part of t into hub.pt
  kSplit,   // the hub chunks' pass 2 with their row's t, then the rows
};

// 3 resident blocks per SM (up to 85 registers) as for gat_fwd; <2, 4>
// spills under that budget once it forms keep bits, so it has none.
template <int VEC, int REPS, BwdItems ITEMS>
__global__ void __launch_bounds__(kWarps * 32, VEC * REPS <= 8 && REPS < 4 ? 3 : 1)
gat_bwd_kernel(const int32_t* __restrict__ indptr, const int32_t* __restrict__ src_of,
               const __nv_bfloat16* __restrict__ feat, const float* __restrict__ el,
               const __nv_bfloat16* __restrict__ er, DropArgs drop_args, float slope,
               const float* __restrict__ smax, const float* __restrict__ denom,
               const float* __restrict__ dout, const __nv_bfloat16* __restrict__ attn_l,
               float* __restrict__ der, __nv_bfloat16* __restrict__ msg,
               float* __restrict__ dal_part, const BwdHub hub, int n_rows, int H, int D, int lh,
               int hp, int slots, int kcache) {
  // (alpha, w, w g, leaky_relu' factor) of the first kcache edges of the
  // warp's row, per head of the pass: [kWarps][kcache][hp]
  extern __shared__ float4 edge_cache[];
  const int lane = threadIdx.x & 31;
  const int warp = blockIdx.x * kWarps + (threadIdx.x >> 5);
  const int n_warps = gridDim.x * kWarps;
  float4* cache = edge_cache + (threadIdx.x >> 5) * kcache * hp;
  const Drop drop = make_drop(drop_args);
  const int hd = H * D;
  const Lanes L = lanes_of(lane, lh, hp);
  const int q = L.q, hh = L.hh, sub = L.sub, le = L.le;
  // with chunks, the chunks are the first items (item < n_chunks: an edge
  // range of a split row), then, unless kChunkT, the rows (item -
  // n_chunks, unless it has more than chunk_edges edges)
  constexpr bool kChunks = ITEMS != BwdItems::kRows;
  const int n_chunks = kChunks ? hub.n_chunks : 0;
  const int n_items = ITEMS == BwdItems::kChunkT ? n_chunks : n_chunks + n_rows;

  for (int h0 = 0; h0 < H; h0 += hp) {  // one pass unless H * LH > 32
    const int h = h0 + hh;
    const bool lane_ok = q < slots && h < H;
    const unsigned cols = col_bits<VEC, REPS>(lane_ok, lh, sub, D);
    float dal[REPS][VEC];  // this lane's dattn_l partial for its columns
#pragma unroll
    for (int r = 0; r < REPS; ++r)
#pragma unroll
      for (int k = 0; k < VEC; ++k) dal[r][k] = 0.f;

    for (int item = warp; item < n_items; item += n_warps) {  // warp-uniform
      const bool chunk = kChunks && item < n_chunks;
      int start, end, row;
      if (chunk) {
        const int2 c = hub.chunks[item];
        start = c.x;
        end = c.y;
        row = hub.rows[hub.owner[item]];
      } else {
        row = item - n_chunks;
        start = indptr[row];
        end = indptr[row + 1];
        if (kChunks && end - start > hub.chunk_edges) continue;  // its chunks walk it
      }
      const int64_t vh = static_cast<int64_t>(row) * H + h;
      if (start == end) {  // no in-edges: nothing flows back (a chunk is never empty)
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

      // a chunk caches nothing: its pass 2 recomputes every edge's terms
      const int kc = chunk ? 0 : kcache;

      float t = 0.f;
      if (ITEMS == BwdItems::kSplit && chunk) {
        // the row's t: its chunks' parts in chunk order, the same sum in
        // every chunk warp of the row
        if (lane_ok) {
          const int s = hub.owner[item];
          for (int k = hub.first[s]; k < hub.first[s + 1]; ++k)
            t += hub.pt[static_cast<int64_t>(k) * H + h];
        }
      } else {
        // pass 1: alpha, w and g of every edge, t, and the cache
        for (int e0 = start; e0 < end; e0 += 32) {
          const int n = min(32, end - e0);
          const int mine = lane < n ? src_of[e0 + lane] : 0;
          const unsigned kept = lane < n ? keep_bits(drop, e0 + lane, H, h0, hp) : 0u;
          const int steps = (n + slots - 1) / slots;  // warp-uniform
          for (int j = 0; j < steps; ++j) {
            const int k = j * slots + q;
            const int src = __shfl_sync(kFull, mine, k & 31);
            const unsigned bits = __shfl_sync(kFull, kept, k & 31);
            const bool on = lane_ok && k < n;
            EdgeTerms et{0.f, 0.f};
            float f[REPS][VEC];
            if (on) {
              et = edge_terms(el[static_cast<int64_t>(src) * H + h], er_v, m_v, inv_den, slope);
              load_slice<VEC, REPS>(feat + static_cast<int64_t>(src) * hd + h * D, cols, lh, sub,
                                    f);
            }
            const float g = head_sum(on ? dot<VEC, REPS>(f, go, cols) : 0.f, sub, lh);
            if (!on) continue;
            const float w = (bits >> hh & 1u) ? drop.inv_keep : 0.f;
            const float wg = w * g;
            t += et.alpha * wg;
            const int ro = e0 - start + k;  // edge of the row
            if (ro < kc && sub == 0)
              cache[ro * hp + hh] = make_float4(et.alpha, w, wg, et.s_pre >= 0.f ? 1.f : slope);
          }
        }
        t = __shfl_sync(kFull, slot_fold(t, q, slots, le), lane - q * le);  // the item's t
      }
      if (ITEMS == BwdItems::kChunkT) {  // the chunk's part of its row's t
        if (lane_ok && q == 0 && sub == 0) hub.pt[static_cast<int64_t>(item) * H + h] = t;
        continue;
      }
      __syncwarp();  // the cache written above is read by other lanes below

      // pass 2: the softmax VJP per edge, from the cache (recomputed past
      // it); the feature slice is read again for dattn_l, attn_l from L1
      const __nv_bfloat16* alrow = attn_l + h * D;
      float der_acc = 0.f;
      for (int e0 = start; e0 < end; e0 += 32) {
        const int n = min(32, end - e0);
        const int mine = lane < n ? src_of[e0 + lane] : 0;
        const int steps = (n + slots - 1) / slots;
        // every step of the chunk cached: no keep bits needed (warp-uniform)
        const bool chunk_cached = e0 - start + steps * slots <= kc;
        const unsigned kept =
            lane < n && !chunk_cached ? keep_bits(drop, e0 + lane, H, h0, hp) : 0u;
        for (int j = 0; j < steps; ++j) {
          const int k = j * slots + q;
          const int src = __shfl_sync(kFull, mine, k & 31);
          const unsigned bits = __shfl_sync(kFull, kept, k & 31);
          const bool on = lane_ok && k < n;
          const bool cached = e0 - start + (j + 1) * slots <= kc;  // warp-uniform
          float4 es = make_float4(0.f, 0.f, 0.f, 0.f);  // (alpha, w, w g, leaky_relu')
          float f[REPS][VEC];
          if (on) {
            if (cached) {
              es = cache[(e0 - start + k) * hp + hh];
            } else {
              const EdgeTerms et =
                  edge_terms(el[static_cast<int64_t>(src) * H + h], er_v, m_v, inv_den, slope);
              es = make_float4(et.alpha, (bits >> hh & 1u) ? drop.inv_keep : 0.f, 0.f,
                               et.s_pre >= 0.f ? 1.f : slope);
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
      // a chunk's part of der goes to pder, which gat_bwd_combine_kernel sums
      if (lane_ok && q == 0 && sub == 0)
        (chunk ? hub.pder + static_cast<int64_t>(item) * H + h : der + vh)[0] = der_acc;
      __syncwarp();  // every lane is done with the cache before the next item
    }
    if (ITEMS == BwdItems::kChunkT) continue;  // no dattn_l in pass 1

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

// Hub rows, after gat_bwd_kernel: one warp per split row s sums its chunks'
// der partials in chunk order into der[row].
__global__ void __launch_bounds__(kWarps * 32)
gat_bwd_combine_kernel(const BwdHub hub, float* __restrict__ der, int n_split, int H) {
  const int lane = threadIdx.x & 31;
  const int s = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (s >= n_split) return;
  const int64_t row = hub.rows[s];
  for (int h = lane; h < H; h += 32) {
    float d = 0.f;
    for (int k = hub.first[s]; k < hub.first[s + 1]; ++k)
      d += hub.pder[static_cast<int64_t>(k) * H + h];
    der[row * H + h] = d;
  }
}

#define GAT_CASES(X) \
  X(1, 1) X(1, 2) X(1, 4) X(2, 1) X(2, 2) X(2, 4) X(4, 1) X(4, 2) X(4, 4) X(8, 1) X(8, 2) X(8, 4)

// the GAT kernels' lane layout (see the note at the top), as
// ops/gat_cuda.py `fwd_geometry` and `bwd_geometry` work it out; gat_bwd
// keeps kcache edges' terms per warp
struct AttnGeometry {
  int vec, reps, lh, hp, slots, kcache;
};

int bwd_smem_bytes(const AttnGeometry& g) {
  return kWarps * g.kcache * g.hp * static_cast<int>(sizeof(float4));
}

// a lane layout the kernels instantiate and that covers every column of
// every head and keeps each lane's loads aligned
bool lanes_ok(const AttnGeometry& g, int H, int D, uintptr_t align) {
  return (g.vec == 1 || g.vec == 2 || g.vec == 4 || g.vec == 8) && D % g.vec == 0 &&
         align % (g.vec * sizeof(__nv_bfloat16)) == 0 &&
         (g.reps == 1 || g.reps == 2 || g.reps == 4) && g.lh >= 1 &&
         g.lh * g.reps * g.vec >= D && g.hp >= 1 && g.hp <= H && g.slots >= 1 &&
         g.hp * g.lh * g.slots <= 32;
}

// gat_fwd holds at most kFwdMaxHeads heads' scores per lane
bool fwd_geometry_ok(const AttnGeometry& g, int H, int D, uintptr_t align) {
  return lanes_ok(g, H, D, align) && g.hp <= kFwdMaxHeads;
}

// gat_bwd walks all heads at once when it walks several edges, and its
// cache fits the shared memory a block gets without opting in
bool bwd_geometry_ok(const AttnGeometry& g, int H, int D, uintptr_t align) {
  return lanes_ok(g, H, D, align) && (g.slots == 1 || g.hp == H) && g.kcache >= 0 &&
         bwd_smem_bytes(g) <= 48 * 1024;
}

bool drop_ok(const void* keep, const void* seed) { return keep == nullptr || seed == nullptr; }

// ---- the standalone segment softmax ----------------------------------------

int lanes_per_edge(int H) {
  int g = 1;
  while (g < H && g < 32) g *= 2;
  return g;
}

// one segment's softmax by the whole warp: g lanes per edge, 32 / g edges
// per step; the max first, then a compensated sum of exp(s - max)
__device__ __forceinline__ void softmax_row_warp(const float* __restrict__ scores,
                                                 float* __restrict__ alpha, int start, int end,
                                                 int H, int G) {
  const int lane = threadIdx.x & 31;
  const int per = 32 / G;  // edges per step
  const int slot = lane / G;
  for (int h0 = 0; h0 < H; h0 += G) {
    const int h = h0 + (lane & (G - 1));
    const bool head_ok = h < H;
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
      alpha[i] = __fdividef(expf(scores[i] - m), den);  // den >= 1
    }
  }
}

// Hub rows of the segment softmax (see the note at the top): one warp per
// chunk of a split row, lanes as in softmax_row_warp (g lanes per edge,
// 32 / g edges per step). A lane walks its edges e = start + slot, + 32 /
// g, ... in order, kSmxInFlight scores loaded before the first is used,
// and calls f(score, e) on each.
constexpr int kSmxInFlight = 8;

template <class F>
__device__ __forceinline__ void chunk_scores(const float* __restrict__ scores, int start,
                                             int end, int H, int G, int h, F f) {
  const int per = 32 / G;
  for (int e0 = start + (threadIdx.x & 31) / G; e0 < end; e0 += kSmxInFlight * per) {
    float v[kSmxInFlight];
#pragma unroll
    for (int u = 0; u < kSmxInFlight; ++u) {
      const int e = e0 + u * per;
      v[u] = e < end ? scores[static_cast<int64_t>(e) * H + h] : 0.f;
    }
#pragma unroll
    for (int u = 0; u < kSmxInFlight; ++u)
      if (e0 + u * per < end) f(v[u], e0 + u * per);
  }
}

// the final max of split row s for head h: the largest of its chunks'
// maxima (a max is exact in any order)
__device__ __forceinline__ float split_max(const HubArgs& hub, int s, int H, int h) {
  float m = -CUDART_INF_F;
  for (int k = hub.first[s]; k < hub.first[s + 1]; ++k)
    m = fmaxf(m, hub.pmax[static_cast<int64_t>(k) * H + h]);
  return m;
}

// pass 1 of the split rows: each chunk's max per head into pmax
__global__ void __launch_bounds__(kWarps * 32)
edge_softmax_hub_max_kernel(const HubArgs hub, const float* __restrict__ scores, int H, int G) {
  const int lane = threadIdx.x & 31;
  const int c = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (c >= hub.n_chunks) return;  // the whole warp leaves together
  const int2 range = hub.chunks[c];
  for (int h0 = 0; h0 < H; h0 += G) {
    const int h = h0 + (lane & (G - 1));
    float m = -CUDART_INF_F;
    if (h < H) chunk_scores(scores, range.x, range.y, H, G, h, [&](float v, int) {
      m = fmaxf(m, v);
    });
    for (int off = 16; off >= G; off >>= 1) m = fmaxf(m, __shfl_xor_sync(kFull, m, off));
    if (h < H && lane < G) hub.pmax[static_cast<int64_t>(c) * H + h] = m;
  }
}

// pass 2: each chunk's compensated sum of exp(s - M) per head into pden,
// M its row's final max
__global__ void __launch_bounds__(kWarps * 32)
edge_softmax_hub_sum_kernel(const HubArgs hub, const float* __restrict__ scores, int H, int G) {
  const int lane = threadIdx.x & 31;
  const int c = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (c >= hub.n_chunks) return;  // the whole warp leaves together
  const int2 range = hub.chunks[c];
  const int s = hub.owner[c];
  for (int h0 = 0; h0 < H; h0 += G) {
    const int h = h0 + (lane & (G - 1));
    float den = 0.f;
    float comp = 0.f;  // the sum's lost low-order part
    if (h < H) {
      const float m = split_max(hub, s, H, h);
      chunk_scores(scores, range.x, range.y, H, G, h, [&](float v, int) {
        const float y = expf(v - m) - comp;
        const float sum = den + y;
        comp = (sum - den) - y;
        den = sum;
      });
      den -= comp;
    }
    for (int off = 16; off >= G; off >>= 1) den += __shfl_xor_sync(kFull, den, off);
    if (h < H && lane < G) hub.pden[static_cast<int64_t>(c) * H + h] = den;
  }
}

// pass 3, chunk c's items of edge_softmax_fwd_kernel: alpha = exp(s - M) /
// den, with den its row's chunks' sums added in chunk order
__device__ __forceinline__ void softmax_chunk_alpha(const HubArgs& hub,
                                                    const float* __restrict__ scores,
                                                    float* __restrict__ alpha, int c, int H,
                                                    int G) {
  const int lane = threadIdx.x & 31;
  const int2 range = hub.chunks[c];
  const int s = hub.owner[c];
  for (int h0 = 0; h0 < H; h0 += G) {
    const int h = h0 + (lane & (G - 1));
    if (h >= H) continue;
    const float m = split_max(hub, s, H, h);
    float den = 0.f;
    for (int k = hub.first[s]; k < hub.first[s + 1]; ++k)
      den += hub.pden[static_cast<int64_t>(k) * H + h];
    chunk_scores(scores, range.x, range.y, H, G, h, [&](float v, int e) {
      alpha[static_cast<int64_t>(e) * H + h] = __fdividef(expf(v - m), den);  // den >= 1
    });
  }
}

// scores per lane that edge_softmax_fwd holds (SOFTMAX_REGS in
// ops/gat_cuda.py; tools/sweep_cuda_kernels.py rebuilds other values)
constexpr int kSoftmaxRegs = 8;

// G lanes per edge, P edge slots per row, 32 / (G P) consecutive rows per
// warp; a row of at most P R edges is held in R registers per lane. One
// row group per warp (a grid of resident blocks striding over the groups
// was 5-30% slower on the card). With HUB, the first hub.n_chunks warps
// each write a chunk of a split row (pass 3), and the row groups leave the
// rows of more than chunk_edges edges to them.
template <bool HUB>
__global__ void __launch_bounds__(kWarps * 32)
edge_softmax_fwd_kernel(const int32_t* __restrict__ indptr, const float* __restrict__ scores,
                        float* __restrict__ alpha, const HubArgs hub, int n_rows, int H, int G,
                        int P) {
  const int lane = threadIdx.x & 31;
  int w = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (HUB) {
    if (w < hub.n_chunks) {  // warp-uniform
      softmax_chunk_alpha(hub, scores, alpha, w, H, G);
      return;
    }
    w -= hub.n_chunks;
  }
  const int gp = G * P;
  const int row0 = w * (32 / gp);
  if (row0 >= n_rows) return;  // the whole warp leaves together
  const int grp = lane / gp;
  const int q = (lane - grp * gp) / G;  // edge slot
  const int row = row0 + grp;
  const bool row_ok = row < n_rows;
  const int start = row_ok ? indptr[row] : 0;
  const int end = row_ok ? indptr[row + 1] : 0;
  constexpr int R = kSoftmaxRegs;
  const bool fits = end - start <= P * R;

  for (int h0 = 0; h0 < H; h0 += G) {
    const int h = h0 + (lane & (G - 1));
    const bool ok = fits && h < H;
    float v[R];
    float m = -CUDART_INF_F;
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int e = start + q + r * P;
      v[r] = ok && e < end ? scores[static_cast<int64_t>(e) * H + h] : -CUDART_INF_F;
      m = fmaxf(m, v[r]);
    }
    for (int off = G; off < gp; off <<= 1) m = fmaxf(m, __shfl_xor_sync(kFull, m, off));
    float den = 0.f;
#pragma unroll
    for (int r = 0; r < R; ++r) {
      v[r] = ok && start + q + r * P < end ? expf(v[r] - m) : 0.f;
      den += v[r];
    }
    for (int off = G; off < gp; off <<= 1) den += __shfl_xor_sync(kFull, den, off);
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int e = start + q + r * P;
      // den >= 1 (the max term is exp(0))
      if (ok && e < end) alpha[static_cast<int64_t>(e) * H + h] = __fdividef(v[r], den);
    }
  }

  // the warp's rows that did not fit, one after another by the whole warp
  // (with HUB, those of at most chunk_edges edges)
  const bool split = HUB && end - start > hub.chunk_edges;
  unsigned long_rows = __ballot_sync(kFull, row_ok && !fits && !split && lane == grp * gp);
  while (long_rows) {
    const int first = __ffs(long_rows) - 1;
    long_rows &= long_rows - 1;
    const int lrow = row0 + first / gp;
    softmax_row_warp(scores, alpha, indptr[lrow], indptr[lrow + 1], H, G);
  }
}

// chunk_scores over two arrays: f(a, b, e) on each of the lane's edges in
// order, kSmxInFlight values of each loaded before the first is used
template <class F>
__device__ __forceinline__ void chunk_pairs(const float* __restrict__ a,
                                            const float* __restrict__ b, int start, int end,
                                            int H, int G, int h, F f) {
  const int per = 32 / G;
  for (int e0 = start + (threadIdx.x & 31) / G; e0 < end; e0 += kSmxInFlight * per) {
    float va[kSmxInFlight];
    float vb[kSmxInFlight];
#pragma unroll
    for (int u = 0; u < kSmxInFlight; ++u) {
      const int e = e0 + u * per;
      const int64_t i = static_cast<int64_t>(e) * H + h;
      va[u] = e < end ? a[i] : 0.f;
      vb[u] = e < end ? b[i] : 0.f;
    }
#pragma unroll
    for (int u = 0; u < kSmxInFlight; ++u)
      if (e0 + u * per < end) f(va[u], vb[u], e0 + u * per);
  }
}

// the backward's t pass of the split rows: each chunk's sum of alpha *
// dalpha per head into pt, the lanes' sums folded as a row warp's are
__global__ void __launch_bounds__(kWarps * 32)
edge_softmax_bwd_hub_t_kernel(const BwdHub hub, const float* __restrict__ alpha,
                              const float* __restrict__ dalpha, int H, int G) {
  const int lane = threadIdx.x & 31;
  const int c = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (c >= hub.n_chunks) return;  // the whole warp leaves together
  const int2 range = hub.chunks[c];
  for (int h0 = 0; h0 < H; h0 += G) {
    const int h = h0 + (lane & (G - 1));
    float t = 0.f;
    if (h < H) chunk_pairs(alpha, dalpha, range.x, range.y, H, G, h, [&](float a, float da, int) {
      t += a * da;
    });
    for (int off = 16; off >= G; off >>= 1) t += __shfl_xor_sync(kFull, t, off);
    if (h < H && lane < G) hub.pt[static_cast<int64_t>(c) * H + h] = t;
  }
}

// chunk c's items of edge_softmax_bwd_kernel: ds over the chunk's edges,
// with t its row's chunks' parts added in chunk order
__device__ __forceinline__ void softmax_bwd_chunk(const BwdHub& hub,
                                                  const float* __restrict__ alpha,
                                                  const float* __restrict__ dalpha,
                                                  float* __restrict__ ds, int c, int H, int G) {
  const int lane = threadIdx.x & 31;
  const int2 range = hub.chunks[c];
  const int s = hub.owner[c];
  for (int h0 = 0; h0 < H; h0 += G) {
    const int h = h0 + (lane & (G - 1));
    if (h >= H) continue;
    float t = 0.f;
    for (int k = hub.first[s]; k < hub.first[s + 1]; ++k)
      t += hub.pt[static_cast<int64_t>(k) * H + h];
    chunk_pairs(alpha, dalpha, range.x, range.y, H, G, h, [&](float a, float da, int e) {
      ds[static_cast<int64_t>(e) * H + h] = a * da - a * t;
    });
  }
}

// One warp per row. With HUB, the first hub.n_chunks warps each write a
// chunk of a split row, and the row warps leave the rows of more than
// chunk_edges edges to them.
template <bool HUB>
__global__ void __launch_bounds__(kWarps * 32)
edge_softmax_bwd_kernel(const int32_t* __restrict__ indptr, const float* __restrict__ alpha,
                        const float* __restrict__ dalpha, float* __restrict__ ds,
                        const BwdHub hub, int n_rows, int H, int G) {
  const int lane = threadIdx.x & 31;
  int row = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (HUB) {
    if (row < hub.n_chunks) {  // warp-uniform
      softmax_bwd_chunk(hub, alpha, dalpha, ds, row, H, G);
      return;
    }
    row -= hub.n_chunks;
  }
  if (row >= n_rows) return;  // the whole warp leaves together
  const int start = indptr[row];
  const int end = indptr[row + 1];
  if (HUB && end - start > hub.chunk_edges) return;  // its chunks write it
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

// The hub plan of gat_fwd's CSR (ops/spmm_cuda.py hub_plan): chunks int32
// [n_chunks, 2], owner int32 [n_chunks], rows int32 [n_split], first int32
// [n_split + 1], cut with T = chunk_edges; the chunks' partials pmax, pden
// f32 [n_chunks, H] and pacc f32 [n_chunks, H, D]. With n_chunks == 0 the
// pointers may be null; gat_fwd_hub_max and gat_fwd_combine then launch
// nothing.
HubArgs hub_args(const void* chunks, const void* owner, const void* rows, const void* first,
                 void* pmax, void* pden, void* pacc, int n_chunks, int chunk_edges) {
  return HubArgs{static_cast<const int2*>(chunks), static_cast<const int32_t*>(owner),
                 static_cast<const int32_t*>(rows), static_cast<const int32_t*>(first),
                 static_cast<float*>(pmax), static_cast<float*>(pden), static_cast<float*>(pacc),
                 n_chunks, chunk_edges};
}

bool hub_ok(const HubArgs& hub) {
  return hub.n_chunks >= 0 && hub.chunk_edges >= 1 &&
         (hub.n_chunks == 0 || (hub.chunks != nullptr && hub.owner != nullptr &&
                                hub.rows != nullptr && hub.first != nullptr &&
                                hub.pmax != nullptr && hub.pden != nullptr &&
                                hub.pacc != nullptr));
}

// the occupancy of gat_fwd's instantiation for (vec, reps, hp) and HB
template <bool HB>
cudaError_t fwd_occupancy(int* n, int vec, int reps, int hp) {
#define OCC_CASE(V, R)                                                                     \
  case V * 16 + R:                                                                         \
    return hp == 1 ? cudaOccupancyMaxActiveBlocksPerMultiprocessor(                        \
                         n, gat_fwd_kernel<V, R, 1, HB>, kWarps * 32, 0)                   \
                   : cudaOccupancyMaxActiveBlocksPerMultiprocessor(                        \
                         n, gat_fwd_kernel<V, R, kFwdMaxHeads, HB>, kWarps * 32, 0);
  switch (vec * 16 + reps) {
    GAT_CASES(OCC_CASE)
    default:
      return cudaErrorInvalidValue;
  }
#undef OCC_CASE
}

// gat_bwd_kernel<vec, reps, ITEMS> on `grid` blocks with the geometry's
// cache; cudaErrorInvalidValue for a (vec, reps) it does not instantiate
template <BwdItems ITEMS>
int launch_bwd(const AttnGeometry& g, unsigned grid, cudaStream_t st, const void* indptr,
               const void* src_of, const void* feat, const void* el, const void* er,
               const DropArgs& drop, float slope, const void* smax, const void* denom,
               const void* dout, const void* attn_l, void* der, void* msg, void* dal_part,
               const BwdHub& hub, int n_rows, int H, int D) {
#define BWD_CASE(V, R)                                                                       \
  case V * 16 + R:                                                                          \
    gat_bwd_kernel<V, R, ITEMS><<<grid, kWarps * 32, bwd_smem_bytes(g), st>>>(             \
        static_cast<const int32_t*>(indptr), static_cast<const int32_t*>(src_of),          \
        static_cast<const __nv_bfloat16*>(feat), static_cast<const float*>(el),            \
        static_cast<const __nv_bfloat16*>(er), drop, slope, static_cast<const float*>(smax), \
        static_cast<const float*>(denom), static_cast<const float*>(dout),                 \
        static_cast<const __nv_bfloat16*>(attn_l), static_cast<float*>(der),               \
        static_cast<__nv_bfloat16*>(msg), static_cast<float*>(dal_part), hub, n_rows, H, D, \
        g.lh, g.hp, g.slots, g.kcache);                                                     \
    break;
  switch (g.vec * 16 + g.reps) {
    GAT_CASES(BWD_CASE)
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
#undef BWD_CASE
  return static_cast<int>(cudaGetLastError());
}

// gat_bwd's hub plan and partials (see BwdHub); null where a launch reads
// none of them
BwdHub bwd_hub(const void* chunks, const void* owner, const void* rows, const void* first,
               void* pt, void* pder, int n_chunks, int chunk_edges) {
  return BwdHub{static_cast<const int2*>(chunks), static_cast<const int32_t*>(owner),
                static_cast<const int32_t*>(rows), static_cast<const int32_t*>(first),
                static_cast<float*>(pt), static_cast<float*>(pder), n_chunks, chunk_edges};
}

// a launch's dropout: a keep mask, a seed or neither (see DropArgs)
DropArgs dropout_of(const void* keep, const void* seed, unsigned thresh, unsigned edge_base,
                    float inv_keep) {
  return DropArgs{static_cast<const uint8_t*>(keep),
                  static_cast<const unsigned long long*>(seed), thresh, edge_base, inv_keep};
}

}  // namespace

extern "C" {

// feat f32 [N, H, D]; attn_l, attn_r f32 [H, D]; feat_b bf16 [N, H, D];
// el f32 [N, H]; er bf16 [N, H]
int gat_prep(const void* feat, const void* attn_l, const void* attn_r, void* feat_b, void* el,
             void* er, int n, int H, int D, void* stream) {
  if (n <= 0 || H <= 0 || D <= 0) return static_cast<int>(cudaGetLastError());
  // a bf16 store of VEC values needs half the alignment of an f32 load of
  // VEC, so feat_b's address counts twice
  const uintptr_t align = reinterpret_cast<uintptr_t>(feat) |
                          reinterpret_cast<uintptr_t>(attn_l) |
                          reinterpret_cast<uintptr_t>(attn_r) |
                          (reinterpret_cast<uintptr_t>(feat_b) * 2);
  const PrepGeometry geo = prep_geometry(D, align);
  const int64_t rows = static_cast<int64_t>(n) * H;
  const int64_t per_block = static_cast<int64_t>(32 / geo.lr) * kWarps;
  const dim3 grid(static_cast<unsigned>((rows + per_block - 1) / per_block)), block(kWarps * 32);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define PREP_CASE(V, R)                                                                      \
  case V * 16 + R:                                                                          \
    gat_prep_kernel<V, R><<<grid, block, 0, st>>>(                                          \
        static_cast<const float*>(feat), static_cast<const float*>(attn_l),                 \
        static_cast<const float*>(attn_r), static_cast<__nv_bfloat16*>(feat_b),             \
        static_cast<float*>(el), static_cast<__nv_bfloat16*>(er), rows, H, D, geo.lr);      \
    break;
  switch (geo.vec * 16 + geo.reps) {
    PREP_CASES(PREP_CASE)
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
#undef PREP_CASE
  return static_cast<int>(cudaGetLastError());
}

// the chunk maxima of gat_fwd's hub rows, launched before gat_fwd: src_of,
// el, er and slope as gat_fwd takes them, the plan and pmax as above
int gat_fwd_hub_max(const void* src_of, const void* el, const void* er, float slope,
                    const void* chunks, const void* owner, const void* rows, void* pmax,
                    int n_chunks, int H, void* stream) {
  const HubArgs hub =
      hub_args(chunks, owner, rows, nullptr, pmax, nullptr, nullptr, n_chunks, 1);
  if (n_chunks < 0 || H <= 0 ||
      (n_chunks > 0 && (chunks == nullptr || owner == nullptr || rows == nullptr ||
                        pmax == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  if (n_chunks == 0) return static_cast<int>(cudaGetLastError());
  gat_fwd_max_kernel<<<(n_chunks + kWarps - 1) / kWarps, kWarps * 32, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      hub, static_cast<const int32_t*>(src_of), static_cast<const float*>(el),
      static_cast<const __nv_bfloat16*>(er), slope, H);
  return static_cast<int>(cudaGetLastError());
}

// the split rows of gat_fwd, launched after it: the plan and the partials as
// above, out, smax and denom as gat_fwd's
int gat_fwd_combine(const void* rows, const void* first, const void* pmax, const void* pden,
                    const void* pacc, void* out, void* smax, void* denom, int n_split, int H,
                    int D, void* stream) {
  const HubArgs hub = hub_args(nullptr, nullptr, rows, first, const_cast<void*>(pmax),
                               const_cast<void*>(pden), const_cast<void*>(pacc), 0, 1);
  if (n_split < 0 || H <= 0 || D <= 0) return static_cast<int>(cudaErrorInvalidValue);
  if (n_split == 0) return static_cast<int>(cudaGetLastError());
  gat_fwd_combine_kernel<<<(n_split + kWarps - 1) / kWarps, kWarps * 32, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      hub, static_cast<float*>(out), static_cast<float*>(smax), static_cast<float*>(denom),
      n_split, H, D);
  return static_cast<int>(cudaGetLastError());
}

// feat bf16 [n_src, H, D]; el f32 [n_src, H]; er bf16 [n_rows, H];
// keep uint8 [E, H] or null; seed one uint64 on the device or null (not
// both); edge_base the seed mode's counter of edge 0; out f32
// [n_rows, H, D]; smax, denom f32 [n_rows, H]; the hub plan and partials as
// above (rows of more than chunk_edges edges are left to gat_fwd_combine);
// (vec, reps, lh, hp, slots) as ops/gat_cuda.py `fwd_geometry` gives them
int gat_fwd(const void* indptr, const void* src_of, const void* feat, const void* el,
            const void* er, const void* keep, const void* seed, unsigned thresh,
            unsigned edge_base, float inv_keep, float slope, void* out, void* smax, void* denom,
            const void* chunks, const void* owner, const void* rows, const void* first,
            const void* pmax, void* pden, void* pacc, int n_chunks, int chunk_edges,
            int n_rows, int H, int D, int n_blocks, int vec, int reps, int lh, int hp,
            int slots, void* stream) {
  if (n_rows + n_chunks <= 0 || H <= 0 || D <= 0 || n_blocks <= 0)
    return static_cast<int>(cudaGetLastError());
  const AttnGeometry geo{vec, reps, lh, hp, slots, 0};
  const HubArgs hub = hub_args(chunks, owner, rows, first, const_cast<void*>(pmax), pden, pacc,
                               n_chunks, chunk_edges);
  if (!fwd_geometry_ok(geo, H, D, reinterpret_cast<uintptr_t>(feat)) || !drop_ok(keep, seed) ||
      n_rows < 0 || !hub_ok(hub))
    return static_cast<int>(cudaErrorInvalidValue);
  const DropArgs drop = dropout_of(keep, seed, thresh, edge_base, inv_keep);
  const dim3 grid(n_blocks), block(kWarps * 32);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  // the instantiation that splits hub rows only where the plan has chunks
#define FWD_KERNEL(V, R, NH, HB)                                                             \
  gat_fwd_kernel<V, R, NH, HB><<<grid, block, 0, st>>>(                                     \
      static_cast<const int32_t*>(indptr), static_cast<const int32_t*>(src_of),            \
      static_cast<const __nv_bfloat16*>(feat), static_cast<const float*>(el),              \
      static_cast<const __nv_bfloat16*>(er), drop, slope, static_cast<float*>(out),        \
      static_cast<float*>(smax), static_cast<float*>(denom), hub, n_rows, H, D, lh, hp, slots)
#define FWD_LAUNCH(V, R, NH)            \
  do {                                  \
    if (n_chunks > 0)                   \
      FWD_KERNEL(V, R, NH, true);       \
    else                                \
      FWD_KERNEL(V, R, NH, false);      \
  } while (0)
#define FWD_CASE(V, R)          \
  case V * 16 + R:              \
    if (hp == 1)                \
      FWD_LAUNCH(V, R, 1);      \
    else                        \
      FWD_LAUNCH(V, R, kFwdMaxHeads); \
    break;
  switch (vec * 16 + reps) {
    GAT_CASES(FWD_CASE)
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
#undef FWD_CASE
#undef FWD_LAUNCH
#undef FWD_KERNEL
  return static_cast<int>(cudaGetLastError());
}

// the hub chunks' parts of t of gat_bwd's split rows, launched before
// gat_bwd: its inputs but the row pointer and attn_l, the plan's chunks,
// owner and rows, and pt f32 [n_chunks, H]; one warp per chunk, with
// gat_bwd's lane layout (vec, reps, lh, hp, slots)
int gat_bwd_hub_t(const void* src_of, const void* feat, const void* el, const void* er,
                  const void* keep, const void* seed, unsigned thresh, unsigned edge_base,
                  float inv_keep, float slope, const void* smax, const void* denom,
                  const void* dout, const void* chunks, const void* owner, const void* rows,
                  void* pt, int n_chunks, int H, int D, int vec, int reps, int lh, int hp,
                  int slots, void* stream) {
  const AttnGeometry geo{vec, reps, lh, hp, slots, 0};
  if (n_chunks < 0 || H <= 0 || D <= 0 ||
      !bwd_geometry_ok(geo, H, D, reinterpret_cast<uintptr_t>(feat)) || !drop_ok(keep, seed) ||
      (n_chunks > 0 && (chunks == nullptr || owner == nullptr || rows == nullptr ||
                        pt == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  if (n_chunks == 0) return static_cast<int>(cudaGetLastError());
  return launch_bwd<BwdItems::kChunkT>(
      geo, (n_chunks + kWarps - 1) / kWarps, static_cast<cudaStream_t>(stream), nullptr,
      src_of, feat, el, er, dropout_of(keep, seed, thresh, edge_base, inv_keep), slope, smax,
      denom, dout, nullptr, nullptr, nullptr, nullptr,
      bwd_hub(chunks, owner, rows, nullptr, pt, nullptr, n_chunks, 1), 0, H, D);
}

// as gat_fwd, plus smax, denom from it; dout f32 [n_rows, H, D];
// attn_l bf16 [H, D]; der f32 [n_rows, H]; msg bf16 [E, H, D] (dst-sorted
// edge order); dal_part f32 [n_blocks * 8, H, D], one partial per warp;
// the hub plan as gat_fwd takes it, pt from gat_bwd_hub_t and pder f32
// [n_chunks, H] (rows of more than chunk_edges edges are left to the
// chunks and gat_bwd_combine); (vec, reps, lh, hp, slots, kcache) as
// ops/gat_cuda.py `bwd_geometry` gives them
int gat_bwd(const void* indptr, const void* src_of, const void* feat, const void* el,
            const void* er, const void* keep, const void* seed, unsigned thresh,
            unsigned edge_base, float inv_keep,
            float slope, const void* smax, const void* denom, const void* dout,
            const void* attn_l, void* der, void* msg, void* dal_part, const void* chunks,
            const void* owner, const void* rows, const void* first, const void* pt, void* pder,
            int n_chunks, int chunk_edges, int n_rows, int H, int D, int n_blocks, int vec,
            int reps, int lh, int hp, int slots, int kcache, void* stream) {
  if (n_rows <= 0 || H <= 0 || D <= 0 || n_blocks <= 0)
    return static_cast<int>(cudaGetLastError());
  const AttnGeometry geo{vec, reps, lh, hp, slots, kcache};
  const uintptr_t align = reinterpret_cast<uintptr_t>(feat) | reinterpret_cast<uintptr_t>(msg);
  const BwdHub hub = bwd_hub(chunks, owner, rows, first, const_cast<void*>(pt), pder,
                             n_chunks, chunk_edges);
  if (!bwd_geometry_ok(geo, H, D, align) || !drop_ok(keep, seed) || n_chunks < 0 ||
      chunk_edges < 1 ||
      (n_chunks > 0 && (chunks == nullptr || owner == nullptr || rows == nullptr ||
                        first == nullptr || pt == nullptr || pder == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  const DropArgs drop = dropout_of(keep, seed, thresh, edge_base, inv_keep);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  // the instantiation that splits hub rows only where the plan has chunks
  if (n_chunks > 0)
    return launch_bwd<BwdItems::kSplit>(geo, n_blocks, st, indptr, src_of, feat, el, er, drop,
                                        slope, smax, denom, dout, attn_l, der, msg, dal_part,
                                        hub, n_rows, H, D);
  return launch_bwd<BwdItems::kRows>(geo, n_blocks, st, indptr, src_of, feat, el, er, drop,
                                     slope, smax, denom, dout, attn_l, der, msg, dal_part, hub,
                                     n_rows, H, D);
}

// the split rows' der, launched after gat_bwd: the plan's rows and first,
// pder from gat_bwd, der as gat_bwd's
int gat_bwd_combine(const void* rows, const void* first, const void* pder, void* der,
                    int n_split, int H, void* stream) {
  if (n_split < 0 || H <= 0) return static_cast<int>(cudaErrorInvalidValue);
  if (n_split == 0) return static_cast<int>(cudaGetLastError());
  gat_bwd_combine_kernel<<<(n_split + kWarps - 1) / kWarps, kWarps * 32, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      bwd_hub(nullptr, nullptr, rows, first, nullptr, const_cast<void*>(pder), 0, 1),
      static_cast<float*>(der), n_split, H);
  return static_cast<int>(cudaGetLastError());
}

// blocks of gat_fwd's instantiation for (vec, reps), hp heads per pass and
// hub rows split (hub != 0) or not that one SM holds at once; a negative
// CUDA error code on failure
int gat_fwd_blocks_per_sm(int vec, int reps, int hp, int hub) {
  int n = 0;
  const cudaError_t err =
      hub ? fwd_occupancy<true>(&n, vec, reps, hp) : fwd_occupancy<false>(&n, vec, reps, hp);
  return err == cudaSuccess ? n : -static_cast<int>(err);
}

// blocks of gat_bwd's instantiation for (vec, reps) with hub rows split
// (hub != 0) or not that one SM holds at once with the cache of (kcache,
// hp); a negative CUDA error code on failure
int gat_bwd_blocks_per_sm(int vec, int reps, int kcache, int hp, int hub) {
  const int smem = bwd_smem_bytes(AttnGeometry{vec, reps, 1, hp, 1, kcache});
  int n = 0;
  cudaError_t err = cudaErrorInvalidValue;
#define OCC_CASE(V, R)                                                                     \
  case V * 16 + R:                                                                         \
    err = hub ? cudaOccupancyMaxActiveBlocksPerMultiprocessor(                             \
                    &n, gat_bwd_kernel<V, R, BwdItems::kSplit>, kWarps * 32, smem)         \
              : cudaOccupancyMaxActiveBlocksPerMultiprocessor(                             \
                    &n, gat_bwd_kernel<V, R, BwdItems::kRows>, kWarps * 32, smem);         \
    break;
  switch (vec * 16 + reps) {
    GAT_CASES(OCC_CASE)
    default:
      break;
  }
#undef OCC_CASE
  return err == cudaSuccess ? n : -static_cast<int>(err);
}

// the split rows' chunk maxima (pass 1, kernel 0) or sums of exp(s - M)
// (pass 2, kernel 1), launched in that order before edge_softmax_fwd:
// scores as it takes them, the plan's chunks, owner and first, pmax and
// pden f32 [n_chunks, H]
int edge_softmax_hub_pass(int kernel, const void* scores, const void* chunks,
                          const void* owner, const void* first, void* pmax, void* pden,
                          int n_chunks, int H, void* stream) {
  const HubArgs hub = hub_args(chunks, owner, nullptr, first, pmax, pden, nullptr, n_chunks, 1);
  if ((kernel != 0 && kernel != 1) || n_chunks < 0 || H <= 0 ||
      (n_chunks > 0 && (chunks == nullptr || pmax == nullptr ||
                        (kernel == 1 && (owner == nullptr || first == nullptr ||
                                         pden == nullptr)))))
    return static_cast<int>(cudaErrorInvalidValue);
  if (n_chunks == 0) return static_cast<int>(cudaGetLastError());
  const dim3 grid((n_chunks + kWarps - 1) / kWarps), block(kWarps * 32);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* s = static_cast<const float*>(scores);
  if (kernel == 0)
    edge_softmax_hub_max_kernel<<<grid, block, 0, st>>>(hub, s, H, lanes_per_edge(H));
  else
    edge_softmax_hub_sum_kernel<<<grid, block, 0, st>>>(hub, s, H, lanes_per_edge(H));
  return static_cast<int>(cudaGetLastError());
}

// scores f32 [E, H] in dst-sorted edge order; alpha f32 [E, H]; p edge
// slots per row as ops/gat_cuda.py `softmax_geometry` gives it; the hub
// plan (chunks, owner, first cut with T = chunk_edges) and pmax, pden from
// edge_softmax_hub_pass (rows of more than chunk_edges edges are left to
// the chunks; null pointers where n_chunks == 0)
int edge_softmax_fwd(const void* indptr, const void* scores, void* alpha, const void* chunks,
                     const void* owner, const void* first, const void* pmax, const void* pden,
                     int n_chunks, int chunk_edges, int n_rows, int H, int p, void* stream) {
  if (n_rows <= 0 || H <= 0) return static_cast<int>(cudaGetLastError());
  const int g = lanes_per_edge(H);
  if (p < 1 || (p & (p - 1)) != 0 || g * p > 32 || n_chunks < 0 || chunk_edges < 1 ||
      (n_chunks > 0 && (chunks == nullptr || owner == nullptr || first == nullptr ||
                        pmax == nullptr || pden == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  const HubArgs hub = hub_args(chunks, owner, nullptr, first, const_cast<void*>(pmax),
                               const_cast<void*>(pden), nullptr, n_chunks, chunk_edges);
  // chunk warps first, then one warp per group of 32 / (g p) rows
  const int rows_per_warp = 32 / (g * p);
  const int64_t warps = n_chunks + (n_rows + rows_per_warp - 1) / rows_per_warp;
  const dim3 grid(static_cast<unsigned>((warps + kWarps - 1) / kWarps)), block(kWarps * 32);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int32_t* ip = static_cast<const int32_t*>(indptr);
  const float* s = static_cast<const float*>(scores);
  float* a = static_cast<float*>(alpha);
  // the instantiation that splits hub rows only where the plan has chunks
  if (n_chunks > 0)
    edge_softmax_fwd_kernel<true><<<grid, block, 0, st>>>(ip, s, a, hub, n_rows, H, g, p);
  else
    edge_softmax_fwd_kernel<false><<<grid, block, 0, st>>>(ip, s, a, hub, n_rows, H, g, p);
  return static_cast<int>(cudaGetLastError());
}

// the split rows' parts of t, launched before edge_softmax_bwd: alpha and
// dalpha as it takes them, the plan's chunks, pt f32 [n_chunks, H]
int edge_softmax_bwd_hub_t(const void* alpha, const void* dalpha, const void* chunks, void* pt,
                           int n_chunks, int H, void* stream) {
  if (n_chunks < 0 || H <= 0 || (n_chunks > 0 && (chunks == nullptr || pt == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  if (n_chunks == 0) return static_cast<int>(cudaGetLastError());
  edge_softmax_bwd_hub_t_kernel<<<(n_chunks + kWarps - 1) / kWarps, kWarps * 32, 0,
                                  static_cast<cudaStream_t>(stream)>>>(
      bwd_hub(chunks, nullptr, nullptr, nullptr, pt, nullptr, n_chunks, 1),
      static_cast<const float*>(alpha), static_cast<const float*>(dalpha), H,
      lanes_per_edge(H));
  return static_cast<int>(cudaGetLastError());
}

// alpha, dalpha, ds f32 [E, H] in dst-sorted edge order; the hub plan
// (chunks, owner, first cut with T = chunk_edges) and pt from
// edge_softmax_bwd_hub_t (rows of more than chunk_edges edges are left to
// the chunks; null pointers where n_chunks == 0)
int edge_softmax_bwd(const void* indptr, const void* alpha, const void* dalpha, void* ds,
                     const void* chunks, const void* owner, const void* first, const void* pt,
                     int n_chunks, int chunk_edges, int n_rows, int H, void* stream) {
  if (n_rows <= 0 || H <= 0) return static_cast<int>(cudaGetLastError());
  if (n_chunks < 0 || chunk_edges < 1 ||
      (n_chunks > 0 &&
       (chunks == nullptr || owner == nullptr || first == nullptr || pt == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  const BwdHub hub = bwd_hub(chunks, owner, nullptr, first, const_cast<void*>(pt), nullptr,
                             n_chunks, chunk_edges);
  // chunk warps first, then one warp per row
  const int64_t warps = static_cast<int64_t>(n_chunks) + n_rows;
  const dim3 grid(static_cast<unsigned>((warps + kWarps - 1) / kWarps)), block(kWarps * 32);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int32_t* ip = static_cast<const int32_t*>(indptr);
  const float* a = static_cast<const float*>(alpha);
  const float* da = static_cast<const float*>(dalpha);
  float* out = static_cast<float*>(ds);
  // the instantiation that splits hub rows only where the plan has chunks
  if (n_chunks > 0)
    edge_softmax_bwd_kernel<true><<<grid, block, 0, st>>>(ip, a, da, out, hub, n_rows, H,
                                                          lanes_per_edge(H));
  else
    edge_softmax_bwd_kernel<false><<<grid, block, 0, st>>>(ip, a, da, out, hub, n_rows, H,
                                                           lanes_per_edge(H));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
