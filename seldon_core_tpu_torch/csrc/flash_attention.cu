// Flash attention forward, hand-written CUDA C++ for Hopper (sm_90a).
//
// Replaces the JAX package's Pallas TPU kernel ops/flash_attention.py
// ::flash_attention (body _flash_kernel, pallas_call at :120), which the
// llama prefill runs when seq_impl="flash".
//
// What bounds it on an H100: at the prefill buckets (S = 16..2048, D = 64)
// attention does ~S/2 multiply-adds per byte it must read, so it is bound by
// operations, not by memory.  This first version computes in f32 on the
// CUDA cores (no mma.sync/wgmma, no TMA): one block per (batch*head, 64-row
// query tile), K/V tiles staged in shared memory as f32, the online-softmax
// state (m, l, acc) in registers.  Scores never touch device memory, so the
// bytes stay at O(S*D); the tensor-core rewrite is later work.
//
// Semantics kept from the TPU kernel:
//   * causal mask is top-left aligned (row >= col), and key tiles wholly
//     above the diagonal are skipped;
//   * rows with no visible key (l == 0) write zeros;
//   * softmax in f32 with a finite NEG_INF.
// Added on this card: any S (the ragged edge is masked here, so no tile
// has to divide S) and grouped K/V heads (KV divides H, head h reads
// kv head h / (H / KV)), so the model need not repeat K/V to H heads.
#include "common.cuh"

namespace {

using namespace sct;

constexpr int BQ = 64;   // query rows per block
constexpr int BK = 64;   // key rows per shared-memory tile
constexpr int NT = 128;  // two threads per query row

struct Strides {
  long long b, h, s;  // elements; the last dim is contiguous
};

template <typename T, int D>
__global__ void __launch_bounds__(NT)
    flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, T* __restrict__ o, int H, int groups,
                     int Sq, int Sk, Strides qst, Strides kst, Strides vst,
                     Strides ost, float scale, int causal) {
  constexpr int LD = D + 1;   // padded rows: neighbouring rows hit other banks
  constexpr int LP = BK + 1;
  constexpr int HK = BK / 2;  // keys per thread (interleaved: 2*jj + half)
  constexpr int HD = D / 2;   // output dims per thread (interleaved: 2*dd + half)
  extern __shared__ float smem[];
  float* sq = smem;          // BQ x LD, pre-scaled queries
  float* sk = sq + BQ * LD;  // BK x LD
  float* sv = sk + BK * LD;  // BK x LD
  float* sp = sv + BK * LD;  // BQ x LP, this tile's probabilities

  const int bh = blockIdx.x;
  const int b = bh / H, h = bh - b * H, kh = h / groups;
  // heaviest causal tiles (largest q0) are scheduled first
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;
  const int t = threadIdx.x, r = t >> 1, half = t & 1;
  const int row = q0 + r;
  const T* qb = q + b * qst.b + h * qst.h;
  const T* kb = k + b * kst.b + kh * kst.h;
  const T* vb = v + b * vst.b + kh * vst.h;
  T* ob = o + b * ost.b + h * ost.h;

  for (int i = t; i < BQ * D; i += NT) {
    const int rr = i / D, d = i - rr * D;
    const int qr = q0 + rr;
    sq[rr * LD + d] = qr < Sq ? to_f(qb[qr * qst.s + d]) * scale : 0.f;
  }
  float acc[HD];
#pragma unroll
  for (int dd = 0; dd < HD; ++dd) acc[dd] = 0.f;
  float m = NEG_INF, l = 0.f;
  // causal: keys past the tile's last row are never visible (block-uniform)
  const int k_end = causal ? min(Sk, q0 + BQ) : Sk;
  for (int k0 = 0; k0 < k_end; k0 += BK) {
    __syncthreads();  // the previous tile's readers are done
    for (int i = t; i < BK * D; i += NT) {
      const int c = i / D, d = i - c * D;
      const int kr = k0 + c;
      const bool in = kr < Sk;
      sk[c * LD + d] = in ? to_f(kb[kr * kst.s + d]) : 0.f;
      sv[c * LD + d] = in ? to_f(vb[kr * vst.s + d]) : 0.f;
    }
    __syncthreads();
    float s[HK];
#pragma unroll
    for (int jj = 0; jj < HK; ++jj) s[jj] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      const float qd = sq[r * LD + d];
#pragma unroll
      for (int jj = 0; jj < HK; ++jj) s[jj] += qd * sk[(2 * jj + half) * LD + d];
    }
    float mt = NEG_INF;
#pragma unroll
    for (int jj = 0; jj < HK; ++jj) {
      const int col = k0 + 2 * jj + half;
      const bool ok = col < Sk && (!causal || col <= row);
      s[jj] = ok ? s[jj] : NEG_INF;
      mt = fmaxf(mt, s[jj]);
    }
    mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, 1));
    const float m_new = fmaxf(m, mt);
    const float alpha = expf(m - m_new);
    float ls = 0.f;
#pragma unroll
    for (int jj = 0; jj < HK; ++jj) {
      const int col = k0 + 2 * jj + half;
      const bool ok = col < Sk && (!causal || col <= row);
      const float p = ok ? expf(s[jj] - m_new) : 0.f;
      sp[r * LP + 2 * jj + half] = p;
      ls += p;
    }
    ls += __shfl_xor_sync(0xffffffffu, ls, 1);
    l = l * alpha + ls;
    m = m_new;
    __syncthreads();  // sp complete for every row
#pragma unroll
    for (int dd = 0; dd < HD; ++dd) acc[dd] *= alpha;
    for (int j = 0; j < BK; ++j) {
      const float pj = sp[r * LP + j];
      const float* vr = sv + j * LD + half;
#pragma unroll
      for (int dd = 0; dd < HD; ++dd) acc[dd] += pj * vr[2 * dd];
    }
  }
  if (row < Sq) {
    const float inv = l > 0.f ? 1.f / l : 0.f;  // fully masked rows -> zeros
    T* orow = ob + row * ost.s;
#pragma unroll
    for (int dd = 0; dd < HD; ++dd) orow[2 * dd + half] = from_f<T>(acc[dd] * inv);
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, int B, int H,
                   int KV, int Sq, int Sk, Strides qst, Strides kst, Strides vst,
                   Strides ost, float scale, int causal, cudaStream_t stream) {
  const size_t smem = sizeof(float) * (BQ * (D + 1) + 2 * BK * (D + 1) + BQ * (BK + 1));
  auto kern = flash_fwd_kernel<T, D>;
  cudaError_t err = allow_smem(kern, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(B * H, (Sq + BQ - 1) / BQ);
  kern<<<grid, NT, smem, stream>>>(static_cast<const T*>(q), static_cast<const T*>(k),
                                   static_cast<const T*>(v), static_cast<T*>(o), H,
                                   H / KV, Sq, Sk, qst, kst, vst, ost, scale, causal);
  return cudaGetLastError();
}

template <typename T>
cudaError_t by_dim(int D, const void* q, const void* k, const void* v, void* o, int B,
                   int H, int KV, int Sq, int Sk, Strides qst, Strides kst, Strides vst,
                   Strides ost, float scale, int causal, cudaStream_t st) {
  switch (D) {
    case 16:
      return launch<T, 16>(q, k, v, o, B, H, KV, Sq, Sk, qst, kst, vst, ost, scale, causal, st);
    case 32:
      return launch<T, 32>(q, k, v, o, B, H, KV, Sq, Sk, qst, kst, vst, ost, scale, causal, st);
    case 64:
      return launch<T, 64>(q, k, v, o, B, H, KV, Sq, Sk, qst, kst, vst, ost, scale, causal, st);
    case 128:
      return launch<T, 128>(q, k, v, o, B, H, KV, Sq, Sk, qst, kst, vst, ost, scale, causal, st);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// q (B, H, Sq, D), k/v (B, KV, Sk, D), o like q, each addressed by its
// (batch, head, row) element strides with D contiguous.  Returns the
// launch's cudaError_t.
extern "C" int sct_flash_attention_fwd(const void* q, const void* k, const void* v, void* o,
                                       int dtype, int B, int H, int KV, int Sq, int Sk,
                                       int D, long long q_sb, long long q_sh, long long q_ss,
                                       long long k_sb, long long k_sh, long long k_ss,
                                       long long v_sb, long long v_sh, long long v_ss,
                                       long long o_sb, long long o_sh, long long o_ss,
                                       float scale, int causal, void* stream) {
  if (B * H == 0 || Sq == 0) return cudaSuccess;
  if (KV <= 0 || H % KV) return cudaErrorInvalidValue;
  const Strides qst{q_sb, q_sh, q_ss}, kst{k_sb, k_sh, k_ss}, vst{v_sb, v_sh, v_ss},
      ost{o_sb, o_sh, o_ss};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case F32:
      return by_dim<float>(D, q, k, v, o, B, H, KV, Sq, Sk, qst, kst, vst, ost, scale, causal, st);
    case F16:
      return by_dim<__half>(D, q, k, v, o, B, H, KV, Sq, Sk, qst, kst, vst, ost, scale, causal, st);
    case BF16:
      return by_dim<__nv_bfloat16>(D, q, k, v, o, B, H, KV, Sq, Sk, qst, kst, vst, ost, scale,
                                   causal, st);
    default:
      return cudaErrorInvalidValue;
  }
}

extern "C" const char* sct_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
