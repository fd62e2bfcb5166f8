// Paged decode attention, hand-written CUDA C++ for Hopper (sm_90a).
//
// Replaces the JAX package's Pallas TPU kernel ops/paged_attention.py
// ::paged_decode_attention (body _paged_kernel, pallas_call at :163), the
// attention read of every decode step (models/llama.py _decode_paged_multi).
//
// What bounds it on an H100: bytes.  A decode step does ~2 multiply-adds per
// KV byte it reads (L = 1, four query heads per KV head), far below the
// ~295 operations per byte where the tensor cores would become the limit,
// so the design reads every visible pool byte once and keeps enough of them
// in flight to fill the card's 3.35 TB/s.  At the served shapes the bound
// (~1.2 us) is below a launch's fixed cost, so there latency rules.
//
// Design (split-KV flash-decoding, one launch):
//   * grid (splits, KV * row chunks, S).  Split s covers the contiguous run
//     of table entries [s * per, (s + 1) * per); the host plans `splits`
//     from the window width alone (ops/paged_attention.py plan_splits),
//     never from pos or the table, so no host sync is needed, and `per` is
//     fixed (8 entries, fewer only for a smaller window), so a slot's
//     summation order does not follow its batch.  Splits whose run starts
//     past the slot's last visible pool row (pos + L - 1) exit at once and
//     are not waited for.
//   * a block's 4 warps take 16-row units of its pages in turn, each warp
//     through its own 3-unit ring of shared memory (2 units in flight by
//     16-byte cp.async while one is computed; 2-unit where a row of one KV
//     head exceeds 256 bytes), rows unpadded with their 16-byte chunks
//     XOR-swizzled so that neither the copies nor the reads conflict on
//     banks.  Lane (key, half) dots half of its key's K row with every
//     query row of the block (up to RB = 4 of the L * groups rows, kept in
//     shared memory in f32; more rows take more blocks), so each K row read
//     serves all the query heads of its group; halves meet by one shuffle.
//     The online softmax runs in f32 per warp (exp2, log2(e) * scale folded
//     into the queries); for P.V each lane owns D / 32 output dims.  int8
//     pages are dequantized in registers by their per-(row, head) scales,
//     folded into the score and into p.
//   * the warps merge through shared memory.  With one non-empty split the
//     block writes the output; otherwise it writes (m, l, acc) in f32 to a
//     scratch buffer, and the last block of its (slot, KV head, row chunk)
//     to finish, found by __threadfence and an atomicAdd on a per-(slot,
//     KV head, row chunk) counter that it resets to 0, merges the partials
//     by log-sum-exp weights (8 splits' loads in flight at a time) and
//     writes the output.
//
// Which dtype takes which path: one kernel for every dtype, templated on the
// query type (f32, f16, bf16) and the page type (the query type, or int8
// with scales in the query type).
//
// Semantics kept from the TPU kernel: query row r = j * groups + g sees pool
// rows [0, pos + j]; rows with nothing visible write zeros.
#include <type_traits>

#include "common.cuh"

namespace {

using namespace sct;

constexpr int NW = 4;        // warps per block
constexpr int NT = 32 * NW;
constexpr int CH = 16;       // pool rows per warp work unit
constexpr int RB = 4;        // query rows per block (ops/paged_attention.py ROWS_PER_BLOCK)
constexpr float LOG2E = 1.4426950408889634f;

__device__ __forceinline__ float neg_inf() { return __int_as_float(0xff800000); }

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// 16-byte async copy; src_bytes = 0 zero-fills the destination
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(dst), "l"(src),
               "r"(src_bytes)
               : "memory");
}
__device__ __forceinline__ void cp_commit() { asm volatile("cp.async.commit_group;" ::: "memory"); }
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}

// One element's raw bits (in the low bits of b) as f32.
template <typename T>
__device__ __forceinline__ float bits_to_f(uint32_t b);
template <>
__device__ __forceinline__ float bits_to_f<float>(uint32_t b) { return __uint_as_float(b); }
template <>
__device__ __forceinline__ float bits_to_f<__nv_bfloat16>(uint32_t b) {
  return __uint_as_float((b & 0xffffu) << 16);
}
template <>
__device__ __forceinline__ float bits_to_f<__half>(uint32_t b) {
  return __half2float(__ushort_as_half(static_cast<unsigned short>(b & 0xffffu)));
}
template <>
__device__ __forceinline__ float bits_to_f<int8_t>(uint32_t b) {
  return static_cast<float>(static_cast<int8_t>(b & 0xffu));
}

// Widest vector (bytes, up to 16) that divides `bytes`.
__host__ __device__ constexpr int vec_bytes(int bytes) {
  return bytes % 16 == 0 ? 16 : bytes % 8 == 0 ? 8 : bytes % 4 == 0 ? 4 : bytes % 2 == 0 ? 2 : 1;
}

// N elements of T starting at logical byte x0 of a shared-memory row whose
// 16-byte chunks are XOR-swizzled by `sw` (chunk c sits at c ^ sw), as f32.
template <typename T, int N>
__device__ __forceinline__ void load_row_f32(const unsigned char* row, int x0, int sw,
                                             float* out) {
  constexpr int ES = sizeof(T), VB = vec_bytes(N * ES), EPV = VB / ES;
  constexpr int WORDS = VB >= 4 ? VB / 4 : 1;
#pragma unroll
  for (int v = 0; v < N / EPV; ++v) {
    const int x = x0 + v * VB;  // a vector never straddles a chunk
    const unsigned char* c = row + ((((x >> 4) ^ sw) << 4) | (x & 15));
    uint32_t w[WORDS];
    if constexpr (VB == 16) {
      const uint4 u = *reinterpret_cast<const uint4*>(c);
      w[0] = u.x, w[1] = u.y, w[2] = u.z, w[3] = u.w;
    } else if constexpr (VB == 8) {
      const uint2 u = *reinterpret_cast<const uint2*>(c);
      w[0] = u.x, w[1] = u.y;
    } else if constexpr (VB == 4) {
      w[0] = *reinterpret_cast<const uint32_t*>(c);
    } else if constexpr (VB == 2) {
      w[0] = *reinterpret_cast<const unsigned short*>(c);
    } else {
      w[0] = *c;
    }
#pragma unroll
    for (int e = 0; e < EPV; ++e) {
      const int byte = e * ES;
      out[v * EPV + e] = bits_to_f<T>(w[byte / 4] >> (8 * (byte % 4)));
    }
  }
}

template <typename TK, int D>
struct Geometry {
  static constexpr int ROW = D * static_cast<int>(sizeof(TK));  // bytes of one pool row, one KV head
  static constexpr int CPR = ROW / 16;            // 16-byte chunks per row
  static constexpr int SWZ = (CPR < 8 ? CPR : 8) - 1;  // row r's chunks XOR (r & SWZ): no bank conflicts
  static constexpr int UNIT = 2 * CH * ROW;       // K rows then V rows of one unit
  static constexpr int STAGES = ROW <= 256 ? 3 : 2;  // units in flight per warp, + 1
  static constexpr int QS = D + 8;                // query row stride (f32), halves padded apart
  static constexpr int MERGE = NW * RB * (D + 2) * 4;  // per-warp (acc, m, l), after the loop
  static constexpr int BUF = NW * STAGES * UNIT > MERGE ? NW * STAGES * UNIT : MERGE;
  static size_t smem(int per) {
    const size_t head = (static_cast<size_t>(RB) * QS + NW * RB * CH) * 4 + 4 * per;
    return ((head + 15) & ~static_cast<size_t>(15)) + BUF;
  }
};

template <typename TQ, typename TK, int D>
__global__ void __launch_bounds__(NT)
    paged_split_kernel(const TQ* __restrict__ q,        // (S, L, H, D)
                       const TK* __restrict__ kp,       // (NB, BS, KV, D)
                       const TK* __restrict__ vp,       // (NB, BS, KV, D)
                       const TQ* __restrict__ k_scale,  // (NB, BS, KV) or null
                       const TQ* __restrict__ v_scale,  // (NB, BS, KV) or null
                       const int* __restrict__ table,   // (S, WB)
                       const int* __restrict__ pos,     // (S,)
                       TQ* __restrict__ o,              // (S, L, H, D)
                       float* __restrict__ part,        // (S, KV * nchunk, splits, RB, D + 2)
                       int* __restrict__ counters,      // (S, KV * nchunk), zero between launches
                       int L, int H, int KV, int NB, int BS, int WB, int per, int nchunk,
                       float scale_log2) {
  using G = Geometry<TK, D>;
  constexpr bool QUANT = std::is_same<TK, int8_t>::value;
  constexpr int HALF = D / 2;                 // dims per lane in the score phase
  constexpr int DPL = D >= 32 ? D / 32 : 1;   // output dims per lane
  constexpr int CPR = G::CPR;
  constexpr int EPC = 16 / static_cast<int>(sizeof(TK));  // elements per chunk

  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int s_last;
  float* sq = reinterpret_cast<float*>(smem);             // RB x QS
  float* sp = sq + RB * G::QS;                            // NW x RB x CH probabilities
  int* stab = reinterpret_cast<int*>(sp + NW * RB * CH);  // this split's table run
  unsigned char* sbuf =
      smem + (((RB * G::QS + NW * RB * CH) * 4 + 4 * per + 15) & ~15);  // NW x STAGES x UNIT

  const int split = blockIdx.x, y = blockIdx.y, slot = blockIdx.z;
  const int kh = y / nchunk, rbase = (y - kh * nchunk) * RB;
  const int groups = H / KV;
  const int nr = min(RB, L * groups - rbase);  // query rows of this block
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  // this split's run of the table and the block's queries (pre-scaled, log2
  // domain) are read while pos is in flight: neither depends on it
  const int base = pos[slot], last = base + L - 1;  // the furthest visible pool row
  const int w0 = split * per;
  for (int i = tid; i < min(per, WB - w0); i += NT)
    stab[i] = min(max(table[static_cast<long long>(slot) * WB + w0 + i], 0), NB - 1);
  for (int i = tid; i < RB * D; i += NT) {
    const int r = i / D, d = i - r * D;
    float x = 0.f;
    if (r < nr) {
      const int rr = rbase + r, j = rr / groups, g = rr - j * groups;
      x = to_f(q[((static_cast<long long>(slot) * L + j) * H + kh * groups + g) * D + d]) *
          scale_log2;
    }
    sq[r * G::QS + (d / HALF) * (HALF + 4) + d % HALF] = x;
  }

  const int need = last < 0 ? 0 : min(WB, last / BS + 1);  // table entries with a visible row
  const int nsplit = (need + per - 1) / per;                // splits with work

  // output element (row r of this block, dim d)
  auto out_at = [&](int r, int d) -> TQ* {
    const int rr = rbase + r, j = rr / groups, g = rr - j * groups;
    return o + ((static_cast<long long>(slot) * L + j) * H + kh * groups + g) * D + d;
  };

  if (split >= max(nsplit, 1)) return;
  if (nsplit == 0) {  // nothing visible to any row: zeros
    for (int i = tid; i < nr * D; i += NT) *out_at(i / D, i % D) = from_f<TQ>(0.f);
    return;
  }
  const int w1 = min(need, w0 + per);
  __syncthreads();

  // units of CH pool rows; the last visible page stops at row `last`
  const int upp = (BS + CH - 1) / CH;
  const int tail = w1 == need ? min(upp, (last - (w1 - 1) * BS) / CH + 1) : upp;
  const int nunits = (w1 - w0 - 1) * upp + tail;
  const int mine = nunits > warp ? (nunits - warp + NW - 1) / NW : 0;
  unsigned char* wbuf = sbuf + warp * G::STAGES * G::UNIT;
  const uint32_t wbuf_s = static_cast<uint32_t>(__cvta_generic_to_shared(wbuf));
  const int key = lane >> 1, half = lane & 1;

  // unit i of this warp: table entry w (within the run), first row off
  auto unit = [&](int i, int& w, int& off) {
    const int u = warp + i * NW;
    w = u / upp;
    off = (u - w * upp) * CH;
  };
  auto issue = [&](int i) {
    int w, off;
    unit(i, w, off);
    const int rows = min(CH, BS - off);
    const long long prow = (static_cast<long long>(stab[w]) * BS + off) * KV + kh;
    const uint32_t dst = wbuf_s + (i % G::STAGES) * G::UNIT;
#pragma unroll
    for (int it = 0; it < CPR; ++it) {  // 2 * CH * CPR chunks over 32 lanes
      const int c = lane + 32 * it;
      const int kv = c / (CH * CPR), rem = c - kv * CH * CPR, rr = rem / CPR, ch = rem - rr * CPR;
      const TK* src = (kv ? vp : kp) + (prow + static_cast<long long>(rr) * KV) * D + ch * EPC;
      cp_async16(dst + (kv * CH + rr) * G::ROW + ((ch ^ (rr & G::SWZ)) << 4), rr < rows ? src : kp,
                 rr < rows ? 16 : 0);
    }
  };
  // this lane's key's scales for unit i (int8 pages)
  auto scales = [&](int i, float& ks, float& vs) {
    int w, off;
    unit(i, w, off);
    ks = vs = 0.f;
    if (key < min(CH, BS - off)) {
      const long long idx = (static_cast<long long>(stab[w]) * BS + off + key) * KV + kh;
      ks = to_f(k_scale[idx]);
      vs = to_f(v_scale[idx]);
    }
  };

  float m[RB], lsum[RB], acc[RB][DPL];
#pragma unroll
  for (int r = 0; r < RB; ++r) {
    m[r] = neg_inf();
    lsum[r] = 0.f;
#pragma unroll
    for (int dd = 0; dd < DPL; ++dd) acc[r][dd] = 0.f;
  }
  float ksc = 1.f, vsc = 1.f, nksc = 1.f, nvsc = 1.f;
#pragma unroll
  for (int i = 0; i < G::STAGES - 1; ++i) {
    if (i < mine) issue(i);
    cp_commit();
  }
  if constexpr (QUANT) {
    if (mine > 0) scales(0, ksc, vsc);
  }
  for (int i = 0; i < mine; ++i) {
    if (i + G::STAGES - 1 < mine) issue(i + G::STAGES - 1);
    cp_commit();
    if constexpr (QUANT) {
      if (i + 1 < mine) scales(i + 1, nksc, nvsc);  // one unit ahead, hidden by this one
    }
    cp_wait<G::STAGES - 1>();
    __syncwarp();
    int w, off;
    unit(i, w, off);
    const int rows = min(CH, BS - off);
    const int kpos = (w0 + w) * BS + off + key;  // this lane's pool row
    const unsigned char* ub = wbuf + (i % G::STAGES) * G::UNIT;

    // scores: half of this lane's K row against every query row
    float kf[HALF];
    load_row_f32<TK, HALF>(ub + key * G::ROW, half * (G::ROW / 2), key & G::SWZ, kf);
    float s[RB];
#pragma unroll
    for (int r = 0; r < RB; ++r) {
      s[r] = 0.f;
      if (r < nr) {  // uniform across the warp
        const float* qr = sq + r * G::QS + half * (HALF + 4);
        float a = 0.f;
#pragma unroll
        for (int d = 0; d < HALF; d += 4) {
          const float4 qv = *reinterpret_cast<const float4*>(qr + d);
          a += qv.x * kf[d] + qv.y * kf[d + 1] + qv.z * kf[d + 2] + qv.w * kf[d + 3];
        }
        s[r] = a + __shfl_xor_sync(0xffffffffu, a, 1);
      }
    }
    float alpha[RB];
#pragma unroll
    for (int r = 0; r < RB; ++r) {
      alpha[r] = 1.f;
      if (r < nr) {  // uniform across the warp
        const int j = (rbase + r) / groups;
        float x = QUANT ? s[r] * ksc : s[r];
        x = key < rows && kpos <= base + j ? x : neg_inf();
        float mx = x;
#pragma unroll
        for (int sh = 2; sh < 32; sh <<= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, sh));
        const float m_new = fmaxf(m[r], mx);
        const float m_use = m_new == neg_inf() ? 0.f : m_new;  // nothing visible yet
        alpha[r] = ex2(m[r] - m_use);
        const float p = ex2(x - m_use);
        lsum[r] = lsum[r] * alpha[r] + p;
        m[r] = m_new;
        if (half == 0) sp[(warp * RB + r) * CH + key] = QUANT ? p * vsc : p;
      }
    }
    __syncwarp();
    // P.V: this lane's output dims [lane * DPL, lane * DPL + DPL)
#pragma unroll
    for (int r = 0; r < RB; ++r)
#pragma unroll
      for (int dd = 0; dd < DPL; ++dd) acc[r][dd] *= alpha[r];
    if (lane * DPL < D) {
      const unsigned char* vbase = ub + CH * G::ROW;
      const int x0 = lane * DPL * static_cast<int>(sizeof(TK));
#pragma unroll
      for (int c = 0; c < CH; c += 4) {
        float vf[4][DPL];
#pragma unroll
        for (int cc = 0; cc < 4; ++cc)
          load_row_f32<TK, DPL>(vbase + (c + cc) * G::ROW, x0, (c + cc) & G::SWZ, vf[cc]);
#pragma unroll
        for (int r = 0; r < RB; ++r) {
          if (r < nr) {
            const float4 pv = *reinterpret_cast<const float4*>(sp + (warp * RB + r) * CH + c);
#pragma unroll
            for (int dd = 0; dd < DPL; ++dd)
              acc[r][dd] += pv.x * vf[0][dd] + pv.y * vf[1][dd] + pv.z * vf[2][dd] + pv.w * vf[3][dd];
          }
        }
      }
    }
    if constexpr (QUANT) {
      ksc = nksc;
      vsc = nvsc;
    }
    __syncwarp();  // the next issue reuses this stage and sp
  }
  cp_wait<0>();

  // merge the 4 warps through shared memory (over the stage buffers)
#pragma unroll
  for (int r = 0; r < RB; ++r) {
#pragma unroll
    for (int sh = 1; sh < 32; sh <<= 1) lsum[r] += __shfl_xor_sync(0xffffffffu, lsum[r], sh);
    lsum[r] *= 0.5f;  // both halves of a key carried its p
  }
  __syncthreads();
  float* mrg = reinterpret_cast<float*>(sbuf);  // NW x RB x (D + 2): acc, m, l
#pragma unroll
  for (int r = 0; r < RB; ++r) {
    if (r < nr) {
      float* mw = mrg + (warp * RB + r) * (D + 2);
      if (lane == 0) {
        mw[D] = m[r];
        mw[D + 1] = lsum[r];
      }
      if (lane * DPL < D) {
#pragma unroll
        for (int dd = 0; dd < DPL; ++dd) mw[lane * DPL + dd] = acc[r][dd];
      }
    }
  }
  __syncthreads();
  const bool direct = nsplit == 1;
  // this (slot, KV head, row chunk)'s partials, one RB x (D + 2) block per split
  float* pbase = part + (static_cast<long long>(slot) * gridDim.y + y) * gridDim.x * RB * (D + 2);
  for (int i = tid; i < nr * D; i += NT) {
    const int r = i / D, d = i - r * D;
    float M = neg_inf();
#pragma unroll
    for (int w = 0; w < NW; ++w) M = fmaxf(M, mrg[(w * RB + r) * (D + 2) + D]);
    float A = 0.f, Lt = 0.f;
    if (M != neg_inf()) {
#pragma unroll
      for (int w = 0; w < NW; ++w) {
        const float* mw = mrg + (w * RB + r) * (D + 2);
        const float e = ex2(mw[D] - M);
        A += e * mw[d];
        Lt += e * mw[D + 1];
      }
    }
    if (direct) {
      *out_at(r, d) = from_f<TQ>(Lt > 0.f ? A / Lt : 0.f);  // fully masked rows -> zeros
    } else {
      float* pr = pbase + (static_cast<long long>(split) * RB + r) * (D + 2);
      pr[d] = A;
      if (d == 0) {
        pr[D] = M;
        pr[D + 1] = Lt;
      }
    }
  }
  if (direct) return;

  // the last split block of this (slot, KV head, row chunk) combines
  __threadfence();
  __syncthreads();
  int* counter = counters + static_cast<long long>(slot) * gridDim.y + y;
  if (tid == 0) s_last = atomicAdd(counter, 1) == nsplit - 1;
  __syncthreads();
  if (!s_last) return;
  __threadfence();
  // every split's (m, l, acc) for this thread's elements, 8 splits' loads in
  // flight at a time, merged by log-sum-exp weights
  for (int i = tid; i < nr * D; i += NT) {
    const int r = i / D, d = i - r * D;
    float M = neg_inf(), A = 0.f, Lt = 0.f;
    for (int s0 = 0; s0 < nsplit; s0 += 8) {
      float mv[8], lv[8], av[8];
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        mv[k] = neg_inf();
        lv[k] = av[k] = 0.f;
        if (s0 + k < nsplit) {
          const float* pr = pbase + (static_cast<long long>(s0 + k) * RB + r) * (D + 2);
          mv[k] = __ldcg(pr + D);
          lv[k] = __ldcg(pr + D + 1);
          av[k] = __ldcg(pr + d);
        }
      }
      float Mc = M;
#pragma unroll
      for (int k = 0; k < 8; ++k) Mc = fmaxf(Mc, mv[k]);
      if (Mc != neg_inf()) {
        const float sc = ex2(M - Mc);  // 0 while nothing was visible
        A *= sc;
        Lt *= sc;
#pragma unroll
        for (int k = 0; k < 8; ++k) {
          const float e = ex2(mv[k] - Mc);
          A += e * av[k];
          Lt += e * lv[k];
        }
        M = Mc;
      }
    }
    *out_at(r, d) = from_f<TQ>(Lt > 0.f ? A / Lt : 0.f);  // fully masked rows -> zeros
  }
  if (tid == 0) *counter = 0;  // ready for the next launch
}

template <typename TQ, typename TK, int D>
cudaError_t launch(const void* q, const void* kp, const void* vp, const void* ks,
                   const void* vs, const void* table, const void* pos, void* o, void* part,
                   void* counters, int S, int L, int H, int KV, int NB, int BS, int WB,
                   int splits, int per, float scale, cudaStream_t stream) {
  const int nchunk = (L * (H / KV) + RB - 1) / RB;
  const size_t smem = Geometry<TK, D>::smem(per);
  auto kern = paged_split_kernel<TQ, TK, D>;
  cudaError_t err = allow_smem(kern, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(splits, KV * nchunk, S);
  kern<<<grid, NT, smem, stream>>>(
      static_cast<const TQ*>(q), static_cast<const TK*>(kp), static_cast<const TK*>(vp),
      static_cast<const TQ*>(ks), static_cast<const TQ*>(vs), static_cast<const int*>(table),
      static_cast<const int*>(pos), static_cast<TQ*>(o), static_cast<float*>(part),
      static_cast<int*>(counters), L, H, KV, NB, BS, WB, per, nchunk, scale * LOG2E);
  return cudaGetLastError();
}

template <typename TQ, typename TK>
cudaError_t by_dim(int D, const void* q, const void* kp, const void* vp, const void* ks,
                   const void* vs, const void* table, const void* pos, void* o, void* part,
                   void* counters, int S, int L, int H, int KV, int NB, int BS, int WB,
                   int splits, int per, float scale, cudaStream_t st) {
  switch (D) {
    case 16:
      return launch<TQ, TK, 16>(q, kp, vp, ks, vs, table, pos, o, part, counters, S, L, H, KV, NB,
                                BS, WB, splits, per, scale, st);
    case 32:
      return launch<TQ, TK, 32>(q, kp, vp, ks, vs, table, pos, o, part, counters, S, L, H, KV, NB,
                                BS, WB, splits, per, scale, st);
    case 64:
      return launch<TQ, TK, 64>(q, kp, vp, ks, vs, table, pos, o, part, counters, S, L, H, KV, NB,
                                BS, WB, splits, per, scale, st);
    case 128:
      return launch<TQ, TK, 128>(q, kp, vp, ks, vs, table, pos, o, part, counters, S, L, H, KV,
                                 NB, BS, WB, splits, per, scale, st);
    default:
      return cudaErrorInvalidValue;
  }
}

template <typename TQ>
cudaError_t by_pages(int kv_dtype, int q_dtype, int D, const void* q, const void* kp,
                     const void* vp, const void* ks, const void* vs, const void* table,
                     const void* pos, void* o, void* part, void* counters, int S, int L, int H,
                     int KV, int NB, int BS, int WB, int splits, int per, float scale,
                     cudaStream_t st) {
  if (kv_dtype == I8)
    return by_dim<TQ, int8_t>(D, q, kp, vp, ks, vs, table, pos, o, part, counters, S, L, H, KV,
                              NB, BS, WB, splits, per, scale, st);
  if (kv_dtype == q_dtype && ks == nullptr)
    return by_dim<TQ, TQ>(D, q, kp, vp, ks, vs, table, pos, o, part, counters, S, L, H, KV, NB,
                          BS, WB, splits, per, scale, st);
  return cudaErrorInvalidValue;
}

}  // namespace

// One layer's paged decode attention: q (S, L, H, D); k/v pages
// (NB, BS, KV, D) in q's dtype, or int8 with k/v scales (NB, BS, KV) in q's
// dtype; table (S, WB) int32; pos (S,) int32; o like q.  All contiguous,
// page pointers 16-byte aligned.  `splits` runs of `per` table entries
// (splits * per >= WB > (splits - 1) * per); with splits > 1,
// `part` holds S * KV * ceil(L * H / KV / 4) * splits * 4 * (D + 2) floats
// and `counters` as many ints as (slot, KV head, row chunk) triples, all 0.
// Returns the launch's cudaError_t.
extern "C" int sct_paged_decode_attention(const void* q, const void* kp, const void* vp,
                                          const void* k_scale, const void* v_scale,
                                          const void* table, const void* pos, void* o, void* part,
                                          void* counters, int q_dtype, int kv_dtype, int S, int L,
                                          int H, int KV, int D, int NB, int BS, int WB, int splits,
                                          int per, float scale, void* stream) {
  if (S == 0 || L == 0) return cudaSuccess;
  if (KV <= 0 || H % KV || NB <= 0 || BS <= 0 || WB <= 0) return cudaErrorInvalidValue;
  if ((k_scale == nullptr) != (v_scale == nullptr)) return cudaErrorInvalidValue;
  if (splits < 1 || per < 1 || static_cast<long long>(splits) * per < WB ||
      static_cast<long long>(splits - 1) * per >= WB)
    return cudaErrorInvalidValue;
  if (splits > 1 && (part == nullptr || counters == nullptr)) return cudaErrorInvalidValue;
  if (reinterpret_cast<uintptr_t>(kp) % 16 || reinterpret_cast<uintptr_t>(vp) % 16)
    return cudaErrorMisalignedAddress;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (q_dtype) {
    case F32:
      return by_pages<float>(kv_dtype, q_dtype, D, q, kp, vp, k_scale, v_scale, table, pos, o,
                             part, counters, S, L, H, KV, NB, BS, WB, splits, per, scale, st);
    case F16:
      return by_pages<__half>(kv_dtype, q_dtype, D, q, kp, vp, k_scale, v_scale, table, pos, o,
                              part, counters, S, L, H, KV, NB, BS, WB, splits, per, scale, st);
    case BF16:
      return by_pages<__nv_bfloat16>(kv_dtype, q_dtype, D, q, kp, vp, k_scale, v_scale, table,
                                     pos, o, part, counters, S, L, H, KV, NB, BS, WB, splits, per,
                                     scale, st);
    default:
      return cudaErrorInvalidValue;
  }
}
