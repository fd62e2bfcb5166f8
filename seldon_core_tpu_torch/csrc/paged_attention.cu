// Paged decode attention, hand-written CUDA C++ for Hopper (sm_90a).
//
// Replaces the JAX package's Pallas TPU kernel ops/paged_attention.py
// ::paged_decode_attention (body _paged_kernel, pallas_call at :163), the
// attention read of every decode step (models/llama.py _decode_paged_multi).
//
// What bounds it on an H100: bytes.  A decode step does ~2 multiply-adds per
// KV byte it reads (L = 1, four query heads per KV head), far below the
// ~295 operations per byte where the tensor cores would become the limit.
// So the design reads every visible pool byte once and writes nothing in
// between: one block per (slot, KV head) stages its R = L * groups query
// rows in shared memory, reads the block table itself, and walks the slot's
// pages one at a time (int8 pages dequantized against their per-(position,
// head) scales on the way into shared memory), keeping the online-softmax
// state in f32.  Pages wholly past the last query are never read.
// Known weakness: at 8 slots x 8 KV heads only 64 blocks run on 132 SMs, so
// the card's bandwidth is far from full; splitting the window across blocks
// (flash-decoding) is later work.
//
// Semantics kept from the TPU kernel: query row r = j * groups + g sees pool
// rows [0, pos + j]; rows with nothing visible write zeros.
#include "common.cuh"

namespace {

using namespace sct;

constexpr int NT = 128;

template <typename TQ, typename TK, int D>
__global__ void __launch_bounds__(NT)
    paged_decode_kernel(const TQ* __restrict__ q,         // (S, L, H, D)
                        const TK* __restrict__ kp,        // (NB, BS, KV, D)
                        const TK* __restrict__ vp,        // (NB, BS, KV, D)
                        const TQ* __restrict__ k_scale,   // (NB, BS, KV) or null
                        const TQ* __restrict__ v_scale,   // (NB, BS, KV) or null
                        const int* __restrict__ table,    // (S, WB)
                        const int* __restrict__ pos,      // (S,)
                        TQ* __restrict__ o,               // (S, L, H, D)
                        int L, int H, int KV, int NB, int BS, int WB, float scale) {
  constexpr int LD = D + 1;
  extern __shared__ float smem[];
  const int kh = blockIdx.x, slot = blockIdx.y;
  const int groups = H / KV, R = L * groups, LS = BS + 1;
  float* sq = smem;             // R x LD, pre-scaled queries
  float* sk = sq + R * LD;      // BS x LD, one dequantized page
  float* sv = sk + BS * LD;     // BS x LD
  float* ss = sv + BS * LD;     // R x LS, scores then probabilities
  float* sacc = ss + R * LS;    // R x D
  float* sm = sacc + R * D;     // R running max
  float* sl = sm + R;           // R running denominator
  float* sa = sl + R;           // R rescale of this page
  const int t = threadIdx.x;
  const int base = pos[slot];

  for (int i = t; i < R * D; i += NT) {
    const int r = i / D, d = i - r * D;
    const int j = r / groups, g = r - j * groups;
    sq[r * LD + d] = to_f(q[((static_cast<long long>(slot) * L + j) * H + kh * groups + g) * D + d]) * scale;
    sacc[i] = 0.f;
  }
  for (int r = t; r < R; r += NT) {
    sm[r] = NEG_INF;
    sl[r] = 0.f;
  }
  const int last = base + L - 1;  // the furthest query position
  const int* trow = table + static_cast<long long>(slot) * WB;
  for (int w = 0; w < WB && w * BS <= last; ++w) {
    const int blk = min(max(trow[w], 0), NB - 1);
    __syncthreads();  // staging done / the previous page's readers done
    for (int i = t; i < BS * D; i += NT) {
      const int c = i / D, d = i - c * D;
      const long long row = (static_cast<long long>(blk) * BS + c) * KV + kh;
      float kf = to_f(kp[row * D + d]);
      float vf = to_f(vp[row * D + d]);
      if (k_scale != nullptr) {
        kf *= to_f(k_scale[row]);
        vf *= to_f(v_scale[row]);
      }
      sk[c * LD + d] = kf;
      sv[c * LD + d] = vf;
    }
    __syncthreads();
    for (int i = t; i < R * BS; i += NT) {
      const int r = i / BS, c = i - r * BS;
      float acc = 0.f;
#pragma unroll 8
      for (int d = 0; d < D; ++d) acc += sq[r * LD + d] * sk[c * LD + d];
      const bool ok = w * BS + c <= base + r / groups;
      ss[r * LS + c] = ok ? acc : NEG_INF;
    }
    __syncthreads();
    for (int r = t; r < R; r += NT) {
      float mt = NEG_INF;
      for (int c = 0; c < BS; ++c) mt = fmaxf(mt, ss[r * LS + c]);
      const float m_new = fmaxf(sm[r], mt);
      const float alpha = expf(sm[r] - m_new);
      float ls = 0.f;
      for (int c = 0; c < BS; ++c) {
        const bool ok = w * BS + c <= base + r / groups;
        const float p = ok ? expf(ss[r * LS + c] - m_new) : 0.f;
        ss[r * LS + c] = p;
        ls += p;
      }
      sl[r] = sl[r] * alpha + ls;
      sm[r] = m_new;
      sa[r] = alpha;
    }
    __syncthreads();
    for (int i = t; i < R * D; i += NT) {
      const int r = i / D, d = i - r * D;
      float a = sacc[i] * sa[r];
      for (int c = 0; c < BS; ++c) a += ss[r * LS + c] * sv[c * LD + d];
      sacc[i] = a;
    }
  }
  __syncthreads();
  for (int i = t; i < R * D; i += NT) {
    const int r = i / D, d = i - r * D;
    const int j = r / groups, g = r - j * groups;
    const float lv = sl[r];
    o[((static_cast<long long>(slot) * L + j) * H + kh * groups + g) * D + d] =
        from_f<TQ>(lv > 0.f ? sacc[i] / lv : 0.f);  // fully masked rows -> zeros
  }
}

template <typename TQ, typename TK, int D>
cudaError_t launch(const void* q, const void* kp, const void* vp, const void* ks,
                   const void* vs, const void* table, const void* pos, void* o, int S,
                   int L, int H, int KV, int NB, int BS, int WB, float scale,
                   cudaStream_t stream) {
  const int R = L * (H / KV);
  const size_t smem =
      sizeof(float) * (R * (D + 1) + 2 * BS * (D + 1) + R * (BS + 1) + R * D + 3 * R);
  auto kern = paged_decode_kernel<TQ, TK, D>;
  cudaError_t err = allow_smem(kern, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(KV, S);
  kern<<<grid, NT, smem, stream>>>(
      static_cast<const TQ*>(q), static_cast<const TK*>(kp), static_cast<const TK*>(vp),
      static_cast<const TQ*>(ks), static_cast<const TQ*>(vs), static_cast<const int*>(table),
      static_cast<const int*>(pos), static_cast<TQ*>(o), L, H, KV, NB, BS, WB, scale);
  return cudaGetLastError();
}

template <typename TQ, typename TK>
cudaError_t by_dim(int D, const void* q, const void* kp, const void* vp, const void* ks,
                   const void* vs, const void* table, const void* pos, void* o, int S,
                   int L, int H, int KV, int NB, int BS, int WB, float scale,
                   cudaStream_t st) {
  switch (D) {
    case 16:
      return launch<TQ, TK, 16>(q, kp, vp, ks, vs, table, pos, o, S, L, H, KV, NB, BS, WB, scale, st);
    case 32:
      return launch<TQ, TK, 32>(q, kp, vp, ks, vs, table, pos, o, S, L, H, KV, NB, BS, WB, scale, st);
    case 64:
      return launch<TQ, TK, 64>(q, kp, vp, ks, vs, table, pos, o, S, L, H, KV, NB, BS, WB, scale, st);
    case 128:
      return launch<TQ, TK, 128>(q, kp, vp, ks, vs, table, pos, o, S, L, H, KV, NB, BS, WB, scale, st);
    default:
      return cudaErrorInvalidValue;
  }
}

template <typename TQ>
cudaError_t by_pages(int kv_dtype, int q_dtype, int D, const void* q, const void* kp,
                     const void* vp, const void* ks, const void* vs, const void* table,
                     const void* pos, void* o, int S, int L, int H, int KV, int NB, int BS,
                     int WB, float scale, cudaStream_t st) {
  if (kv_dtype == I8)
    return by_dim<TQ, int8_t>(D, q, kp, vp, ks, vs, table, pos, o, S, L, H, KV, NB, BS, WB, scale, st);
  if (kv_dtype == q_dtype && ks == nullptr)
    return by_dim<TQ, TQ>(D, q, kp, vp, ks, vs, table, pos, o, S, L, H, KV, NB, BS, WB, scale, st);
  return cudaErrorInvalidValue;
}

}  // namespace

// One layer's paged decode attention: q (S, L, H, D); k/v pages
// (NB, BS, KV, D) in q's dtype, or int8 with k/v scales (NB, BS, KV) in q's
// dtype; table (S, WB) int32; pos (S,) int32; o like q.  All contiguous.
// Returns the launch's cudaError_t.
extern "C" int sct_paged_decode_attention(const void* q, const void* kp, const void* vp,
                                          const void* k_scale, const void* v_scale,
                                          const void* table, const void* pos, void* o,
                                          int q_dtype, int kv_dtype, int S, int L, int H,
                                          int KV, int D, int NB, int BS, int WB, float scale,
                                          void* stream) {
  if (S == 0 || L == 0) return cudaSuccess;
  if (KV <= 0 || H % KV || NB <= 0 || BS <= 0) return cudaErrorInvalidValue;
  if ((k_scale == nullptr) != (v_scale == nullptr)) return cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (q_dtype) {
    case F32:
      return by_pages<float>(kv_dtype, q_dtype, D, q, kp, vp, k_scale, v_scale, table, pos, o,
                             S, L, H, KV, NB, BS, WB, scale, st);
    case F16:
      return by_pages<__half>(kv_dtype, q_dtype, D, q, kp, vp, k_scale, v_scale, table, pos,
                              o, S, L, H, KV, NB, BS, WB, scale, st);
    case BF16:
      return by_pages<__nv_bfloat16>(kv_dtype, q_dtype, D, q, kp, vp, k_scale, v_scale, table,
                                     pos, o, S, L, H, KV, NB, BS, WB, scale, st);
    default:
      return cudaErrorInvalidValue;
  }
}
