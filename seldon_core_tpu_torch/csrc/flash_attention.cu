// Flash attention forward, hand-written CUDA C++ for Hopper (sm_90a).
//
// Replaces the JAX package's Pallas TPU kernel ops/flash_attention.py
// ::flash_attention (body _flash_kernel, pallas_call at :120), which the
// llama prefill runs when seq_impl="flash".
//
// What bounds it on an H100: operations.  At the prefill buckets (S = 16..
// 2048, D = 64) attention does ~S/2 multiply-adds per byte it must read, far
// above the ~295 operations per byte where the bf16 tensor cores (989
// TFLOP/s) and not the 3.35 TB/s of memory are the limit.  So the design
// keeps the scores out of device memory (bytes stay O(S*D)) and runs both
// products on the tensor cores.
//
// Which dtype takes which kernel:
//   * bf16 and f16 (the served path): flash_tc_kernel, on the tensor cores.
//     One CTA per (batch*head, 128-row query tile), heaviest causal tiles
//     first.  A producer warpgroup (one thread issues, 24 registers) keeps
//     64-key K and V tiles in flight with TMA
//     (cp.async.bulk.tensor, tensor maps built on the host through
//     cuTensorMapEncodeTiled, 128-byte swizzle, the ragged edge and any
//     head dim below 64 zero-filled by the copy) into a 3-stage ring of
//     shared memory guarded by mbarriers.  Two consumer warpgroups (240
//     registers each, by setmaxnreg) own 64 query rows each: S = Q.K^T is
//     wgmma m64n64k16 with Q and K read from shared memory, issued one tile
//     ahead so that it runs on the tensor cores while the CUDA cores do
//     this tile's online softmax on the f32 accumulator fragment (quad
//     shuffles, one FFMA and one exp2 per score with log2(e)*scale folded
//     in, only the tiles that cross the diagonal or the ragged edge
//     masked, by a separately compiled max pass; no accumulator is written
//     while a wgmma group is open, so ptxas keeps the products
//     asynchronous).  P is rounded once to the input's 16-bit type in
//     registers and is wgmma's register A operand for O += P.V (m64n64k16,
//     V read from shared memory through the transposed-B layout).  l sums
//     the f32 probabilities.
//   * f32 (chip_smoke.py's f32 reference phase; not served): flash_simt
//     _kernel, the port's first kernel unchanged, f32 FMAs on the CUDA
//     cores, because the tensor cores would round f32 inputs to TF32.
//
// Semantics kept from the TPU kernel, in both kernels:
//   * with Sk == Sq the causal mask is top-left aligned (row >= col), and
//     key tiles wholly above the diagonal are skipped;
//   * rows with no visible key (l == 0) write zeros;
//   * softmax in f32.
// Added on this card: any S (the ragged edge is masked here, so no tile
// has to divide S) and grouped K/V heads (KV divides H, head h reads
// kv head h / (H / KV)), so the model need not repeat K/V.
//
// The causal variant with Sk >= Sq (the suffix prefill over a reused
// prefix or earlier chunks): the mask is bottom-right aligned, query row i
// sees keys [0, Sk - Sq + i], i.e. the rows are the last Sq rows of an
// Sk-row causal prefill.  Sk == Sq is the plain causal kernel.  A suffix
// row gets the bits of the same row of a cold prefill over the same keys,
// because (1) key tiles stay aligned from column 0 on both routes, so the
// row's online softmax sees the same tiles, holding the same visible
// columns, in the same order; (2) a tile in which the row sees nothing
// (past its diagonal: a route processes more or fewer of those, by where
// its query tile starts and by Sk) is an exact no-op: its row max is -inf,
// so the rescale is skipped (alpha = 1, where exp2 of the rounding error
// of m * scale need not be 1) and P = 0 adds exact zeros to l and to O;
// and (3) each score and each P.V product is one row's dot product, which
// no other row of the query tile changes.
#include <cuda.h>  // CUtensorMap and its enums (types only: the driver entry is fetched at run time)

#include <type_traits>

#include "common.cuh"

namespace {

using namespace sct;

struct Strides {
  long long b, h, s;  // elements; the last dim is contiguous
};

// ------------------------------------------------------------------ f32

namespace simt {

constexpr int BQ = 64;   // query rows per block
constexpr int BK = 64;   // key rows per shared-memory tile
constexpr int NT = 128;  // two threads per query row

template <typename T, int D>
__global__ void __launch_bounds__(NT)
    flash_simt_kernel(const T* __restrict__ q, const T* __restrict__ k,
                      const T* __restrict__ v, T* __restrict__ o, int H, int groups,
                      int Sq, int Sk, Strides qst, Strides kst, Strides vst,
                      Strides ost, float scale, int causal, int qoff) {
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
  // causal: keys past the tile's last row (qoff + q0 + BQ - 1 in key
  // coordinates) are never visible (block-uniform)
  const int k_end = causal ? min(Sk, qoff + q0 + BQ) : Sk;
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
      const bool ok = col < Sk && (!causal || col <= qoff + row);
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
      const bool ok = col < Sk && (!causal || col <= qoff + row);
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

template <int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, int B, int H,
                   int KV, int Sq, int Sk, Strides qst, Strides kst, Strides vst,
                   Strides ost, float scale, int causal, int qoff, cudaStream_t stream) {
  const size_t smem = sizeof(float) * (BQ * (D + 1) + 2 * BK * (D + 1) + BQ * (BK + 1));
  auto kern = flash_simt_kernel<float, D>;
  cudaError_t err = allow_smem(kern, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(B * H, (Sq + BQ - 1) / BQ);
  kern<<<grid, NT, smem, stream>>>(static_cast<const float*>(q), static_cast<const float*>(k),
                                   static_cast<const float*>(v), static_cast<float*>(o), H,
                                   H / KV, Sq, Sk, qst, kst, vst, ost, scale, causal, qoff);
  return cudaGetLastError();
}

}  // namespace simt

// ------------------------------------------------------------ bf16 / f16

namespace tc {

constexpr int BQ = 128;        // query rows per CTA: two consumer warpgroups of 64
constexpr int BK = 64;         // keys per K/V tile: at 128 the two score fragments, the
                               // output and P outgrow a consumer's registers and ptxas
                               // serializes the wgmmas (measured slower on an H100)
constexpr int STAGES = 3;      // K/V tiles in flight
constexpr int NCONS = 256;     // consumer threads (warpgroups 0 and 1)
constexpr int NT = NCONS + 128;  // plus one producer warpgroup (one thread issues the copies)
// registers per thread after setmaxnreg: 128 * 24 + 256 * 240 <= 65536
constexpr int PRODUCER_REGS = 24;
constexpr int CONSUMER_REGS = 240;
constexpr int ATOM = 64;       // 16-bit elements in one 128-byte swizzle row
constexpr float LOG2E = 1.4426950408889634f;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ float neg_inf() { return __int_as_float(0xff800000); }

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// ---- mbarriers and TMA

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(bar), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar) : "memory");
}

// Wait until the phase with parity `parity` of the barrier has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

__device__ __forceinline__ void tma_load_4d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3, %4, %5}], [%6];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2), "r"(c3), "r"(bar)
      : "memory");
}

// ---- wgmma

// Shared-memory matrix descriptor for a 128-byte-swizzled tile whose atoms
// (8 rows of 128 bytes, 1024-byte aligned) follow each other every 1024
// bytes; lbo/sbo in bytes.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16) |
         (static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wg_fence() { asm volatile("wgmma.fence.sync.aligned;" ::: "memory"); }
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wg_wait0() {
  asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
}

// Keep the compiler from moving register reads or writes of a wgmma
// accumulator across the asynchronous product.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

// d (64 x 64, f32) (+)= A (64 x 16, K-major in smem) * B (64 x 16, K-major in smem)^T
#define SCT_WGMMA_SS_N64(TY, PT)                                                            \
  __device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t da, uint64_t db,         \
                                           int accumulate, TY) {                             \
    asm volatile(                                                                            \
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"                                         \
        "wgmma.mma_async.sync.aligned.m64n64k16.f32." PT "." PT " "                          \
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "            \
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "  \
        "%32, %33, p, 1, 1, 0, 0;\n}\n"                                                      \
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),           \
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),         \
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),     \
          "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),     \
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),     \
          "+f"(d[30]), "+f"(d[31])                                                          \
        : "l"(da), "l"(db), "r"(accumulate));                                                \
  }
SCT_WGMMA_SS_N64(__nv_bfloat16, "bf16")
SCT_WGMMA_SS_N64(__half, "f16")
#undef SCT_WGMMA_SS_N64

// d (64 x 64, f32) += A (64 x 16, registers) * B (16 x 64, N-major in smem:
// the transposed-B bit)
#define SCT_WGMMA_RS_N64(TY, PT)                                                            \
  __device__ __forceinline__ void wgmma_rs_n64(float (&d)[32], const uint32_t* a,           \
                                               uint64_t db, TY) {                            \
    asm volatile(                                                                            \
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"                                         \
        "wgmma.mma_async.sync.aligned.m64n64k16.f32." PT "." PT " "                          \
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "            \
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "  \
        "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"                                       \
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),           \
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),         \
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),     \
          "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),     \
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),     \
          "+f"(d[30]), "+f"(d[31])                                                          \
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));                      \
  }
SCT_WGMMA_RS_N64(__nv_bfloat16, "bf16")
SCT_WGMMA_RS_N64(__half, "f16")
#undef SCT_WGMMA_RS_N64

__device__ __forceinline__ uint32_t pack2(float a, float b, __nv_bfloat16) {
  __nv_bfloat162 v = __floats2bfloat162_rn(a, b);
  return *reinterpret_cast<uint32_t*>(&v);
}
__device__ __forceinline__ uint32_t pack2(float a, float b, __half) {
  __half2 v = __floats2half2_rn(a, b);
  return *reinterpret_cast<uint32_t*>(&v);
}

// Which of a tensor map's dims 1..3 holds the rows, the heads and the batch.
struct MapDims {
  int row, head, batch;
};

__device__ __forceinline__ int coord(int dim, MapDims m, int row, int head, int batch) {
  return m.row == dim ? row : m.head == dim ? head : batch;
}

template <typename T, int DP>
__global__ void __launch_bounds__(NT, 1)
    flash_tc_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                    const __grid_constant__ CUtensorMap tv, T* __restrict__ o, MapDims mq,
                    MapDims mk, MapDims mv, int H, int groups, int Sq, int Sk, int D, Strides ost,
                    float scale_log2, int causal, int qoff) {
  constexpr int NA = DP / ATOM;              // swizzle atoms across a row
  constexpr int SN = BK / 2;                 // score registers per thread (m64 x BK fragment)
  constexpr uint32_t Q_BYTES = NA * BQ * 128;
  constexpr uint32_t KV_BYTES = NA * BK * 128;  // one K or one V tile
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t sq = base;
  const uint32_t sk = sq + Q_BYTES;               // STAGES K tiles
  const uint32_t sv = sk + STAGES * KV_BYTES;     // STAGES V tiles
  const uint32_t qbar = sv + STAGES * KV_BYTES;   // then full[STAGES], empty[STAGES]
  const uint32_t full0 = qbar + 8, empty0 = full0 + 8 * STAGES;

  const int b = blockIdx.x / H, h = blockIdx.x - b * H, kh = h / groups;
  // heaviest causal tiles (largest q0) are scheduled first
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;
  const int k_tiles = (Sk + BK - 1) / BK;
  const int n_tiles = causal ? min(k_tiles, (qoff + q0 + BQ + BK - 1) / BK) : k_tiles;

  if (threadIdx.x == 0) {
    mbar_init(qbar, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full0 + 8 * s, 1);
      mbar_init(empty0 + 8 * s, 2);  // one arrival per consumer warpgroup
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= NCONS) {
    // producer: one thread issues every copy; the roles never meet again
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;" ::"n"(PRODUCER_REGS));
    if (threadIdx.x == NCONS) {
      mbar_expect_tx(qbar, Q_BYTES);
      for (int a = 0; a < NA; ++a)
        tma_load_4d(sq + a * BQ * 128, &tq, qbar, a * ATOM, coord(1, mq, q0, h, b),
                    coord(2, mq, q0, h, b), coord(3, mq, q0, h, b));
      for (int i = 0; i < n_tiles; ++i) {
        const int s = i % STAGES;
        if (i >= STAGES) mbar_wait(empty0 + 8 * s, ((i / STAGES) - 1) & 1);
        const uint32_t bar = full0 + 8 * s;
        mbar_expect_tx(bar, 2 * KV_BYTES);
        const int k0 = i * BK;
        for (int a = 0; a < NA; ++a) {
          tma_load_4d(sk + s * KV_BYTES + a * BK * 128, &tk, bar, a * ATOM,
                      coord(1, mk, k0, kh, b), coord(2, mk, k0, kh, b), coord(3, mk, k0, kh, b));
          tma_load_4d(sv + s * KV_BYTES + a * BK * 128, &tv, bar, a * ATOM,
                      coord(1, mv, k0, kh, b), coord(2, mv, k0, kh, b), coord(3, mv, k0, kh, b));
        }
      }
    }
    return;
  }

  // consumers: warpgroup wg owns query rows q0 + 64*wg .. +63; this thread
  // holds rows rowA and rowA + 8, columns 8j + 2*(lane % 4) + {0, 1}
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;" ::"n"(CONSUMER_REGS));
  const int wg = threadIdx.x / 128, t = threadIdx.x % 128, lane = t % 32;
  const int rowA = q0 + 64 * wg + 16 * (t / 32) + lane / 4;
  const int c2 = 2 * (lane % 4);
  const uint32_t qtile = sq + wg * 64 * 128;

  float oacc[NA][32];
#pragma unroll
  for (int a = 0; a < NA; ++a)
#pragma unroll
    for (int i = 0; i < 32; ++i) oacc[a][i] = 0.f;
  // two score fragments: the next tile's Q K^T runs on the tensor cores
  // while this tile's softmax runs on the CUDA cores
  float sA[SN], sB[SN];
#pragma unroll
  for (int i = 0; i < SN; ++i) sA[i] = sB[i] = 0.f;
  float m_r[2] = {neg_inf(), neg_inf()}, l_r[2] = {0.f, 0.f};

  // S = Q K^T of tile i into `acc`, over DP / 16 k-steps of 32 bytes
  // inside each swizzle atom; committed as one wgmma group
  auto issue_s = [&](int i, float(&acc)[SN]) {
    const uint32_t ktile = sk + (i % STAGES) * KV_BYTES;
    mbar_wait(full0 + 8 * (i % STAGES), (i / STAGES) & 1);
    wg_fence();
    fence_regs(acc);
#pragma unroll
    for (int a = 0; a < NA; ++a)
#pragma unroll
      for (int kk = 0; kk < ATOM / 16; ++kk)
        wgmma_ss(acc, sw128_desc(qtile + a * BQ * 128 + kk * 32, 16, 1024),
                 sw128_desc(ktile + a * BK * 128 + kk * 32, 16, 1024), (a | kk) != 0, T{});
    wg_commit();
  };

  // tile i: its scores are in `cur` (complete after the wait below); the
  // next tile's go into `nxt`.  No instruction but a wgmma writes a wgmma
  // accumulator while a wgmma group is open (ptxas would serialize them):
  // the row max (which masks `cur` on edge tiles) and the rescale of O come
  // before the next Q K^T is issued, and P is packed from `cur` without
  // writing it back.
  auto step = [&](int i, float(&cur)[SN], float(&nxt)[SN]) {
    wg_wait0();  // S of tile i and P V of tile i - 1 are complete
    fence_regs(cur);
#pragma unroll
    for (int a = 0; a < NA; ++a) fence_regs(oacc[a]);
    if (i > 0 && t == 0) mbar_arrive(empty0 + 8 * ((i - 1) % STAGES));  // tile i - 1 done

    // online softmax in the log2 domain: p = 2^(s * c - m * c), one FFMA
    // and one ex2 per score.  Only tiles crossing the diagonal (causal) or
    // the ragged edge (not causal) need the mask: the max pass is compiled
    // with and without it (`edge` picks one), and the masked one writes
    // -inf over the hidden scores, so the exp pass needs no mask.  Both
    // write no accumulator once the next Q K^T is in flight.
    const int k0 = i * BK;
    const bool edge = causal ? k0 + BK > qoff + q0 + 64 * wg : k0 + BK > Sk;
    auto row_max = [&](auto masked, int hr) {
      const int row = qoff + rowA + 8 * hr;  // in key coordinates
      float mx = neg_inf();
#pragma unroll
      for (int j = 0; j < BK / 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int idx = 4 * j + 2 * hr + e, col = k0 + 8 * j + c2 + e;
          if (decltype(masked)::value && (causal ? col > row : col >= Sk)) cur[idx] = neg_inf();
          mx = fmaxf(mx, cur[idx]);
        }
      return mx;
    };
    float mc[2];
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      float mx = edge ? row_max(std::true_type{}, hr) : row_max(std::false_type{}, hr);
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m_r[hr], mx);
      mc[hr] = (m_new == neg_inf() ? 0.f : m_new) * scale_log2;  // nothing visible yet
      // a tile that shows this row nothing leaves l and O exactly as they
      // are: exp2(m * c - m * c) is the product's rounding error once the
      // compiler fuses it into one FMA, and need not be exactly 1
      const float alpha = mx == neg_inf() ? 1.f : ex2(fmaf(m_r[hr], scale_log2, -mc[hr]));
      l_r[hr] *= alpha;  // this thread's columns; the quad sums at the end
      m_r[hr] = m_new;
#pragma unroll
      for (int a = 0; a < NA; ++a)
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          oacc[a][4 * j + 2 * hr] *= alpha;
          oacc[a][4 * j + 2 * hr + 1] *= alpha;
        }
    }
#pragma unroll
    for (int a = 0; a < NA; ++a) fence_regs(oacc[a]);
    fence_regs(cur);

    if (i + 1 < n_tiles) issue_s(i + 1, nxt);

    // P as wgmma's A fragment: pa[2j + hr] holds row half hr, columns
    // 8j + c2 + {0, 1}
    uint32_t pa[BK / 4];
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      float ls = 0.f;
#pragma unroll
      for (int j = 0; j < BK / 8; ++j) {
        const float p0 = ex2(fmaf(cur[4 * j + 2 * hr], scale_log2, -mc[hr]));
        const float p1 = ex2(fmaf(cur[4 * j + 2 * hr + 1], scale_log2, -mc[hr]));
        ls += p0 + p1;
        pa[2 * j + hr] = pack2(p0, p1, T{});
      }
      l_r[hr] += ls;
    }

    // O += P V: 16 keys (16 rows of 128 bytes, two 1024-byte atoms) per k-step
    const uint32_t vtile = sv + (i % STAGES) * KV_BYTES;
    wg_fence();
#pragma unroll
    for (int a = 0; a < NA; ++a)
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk)
        wgmma_rs_n64(oacc[a], pa + 4 * kk,
                     sw128_desc(vtile + a * BK * 128 + kk * 2048, BK * 128, 1024), T{});
    wg_commit();
  };

  mbar_wait(qbar, 0);
  if (n_tiles > 0) issue_s(0, sA);
  for (int i = 0; i < n_tiles; i += 2) {
    step(i, sA, sB);
    if (i + 1 < n_tiles) step(i + 1, sB, sA);
  }
  wg_wait0();
#pragma unroll
  for (int a = 0; a < NA; ++a) fence_regs(oacc[a]);

  float inv[2];
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    float l = l_r[hr];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    inv[hr] = l > 0.f ? 1.f / l : 0.f;  // fully masked rows -> zeros
  }
  T* ob = o + b * ost.b + h * ost.h;
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int row = rowA + 8 * hr;
    if (row >= Sq) continue;
    T* orow = ob + row * ost.s;
#pragma unroll
    for (int a = 0; a < NA; ++a)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int col = a * ATOM + 8 * j + c2;
        if (col < D) {
          const uint32_t v =
              pack2(oacc[a][4 * j + 2 * hr] * inv[hr], oacc[a][4 * j + 2 * hr + 1] * inv[hr], T{});
          *reinterpret_cast<uint32_t*>(orow + col) = v;
        }
      }
  }
}

// ---- host side

using EncodeTiledFn = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                   const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                   const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                   CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver, without linking libcuda
EncodeTiledFn encode_tiled() {
  static const EncodeTiledFn fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found{};
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    return err == cudaSuccess && found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiledFn>(p)
               : nullptr;
  }();
  return fn;
}

// A 4-D tensor map over one (B, heads, rows, D) operand addressed by its
// element strides: dim 0 is D (box 64, zero-filled past D), dims 1..3 are
// rows, heads and batch sorted by stride (box `box_rows` rows).
cudaError_t make_map(CUtensorMap* map, MapDims* dims, const void* ptr, CUtensorMapDataType dt,
                     int D, long long rows, long long heads, long long batch, long long s_row,
                     long long s_head, long long s_batch, int box_rows) {
  const EncodeTiledFn encode = encode_tiled();
  if (encode == nullptr) return cudaErrorNotSupported;
  if (reinterpret_cast<uintptr_t>(ptr) % 16) return cudaErrorMisalignedAddress;
  struct Dim {
    unsigned long long n, stride;
    int role;
  } d[3] = {{static_cast<unsigned long long>(rows), static_cast<unsigned long long>(s_row) * 2, 0},
            {static_cast<unsigned long long>(heads), static_cast<unsigned long long>(s_head) * 2, 1},
            {static_cast<unsigned long long>(batch), static_cast<unsigned long long>(s_batch) * 2,
             2}};
  // a dim of extent 1 may carry any stride: place it past every other
  unsigned long long span = 2ull * D;
  for (const Dim& x : d)
    if (x.n > 1 && x.n * x.stride > span) span = x.n * x.stride;
  span = (span + 15) & ~15ull;
  for (Dim& x : d)
    if (x.n <= 1) x.stride = span;
  for (int i = 1; i < 3; ++i)  // insertion sort by stride
    for (int j = i; j > 0 && d[j].stride < d[j - 1].stride; --j) {
      const Dim tmp = d[j];
      d[j] = d[j - 1];
      d[j - 1] = tmp;
    }
  cuuint64_t gdim[4] = {static_cast<cuuint64_t>(D), 1, 1, 1};
  cuuint64_t gstride[3];
  cuuint32_t box[4] = {ATOM, 1, 1, 1};
  const cuuint32_t estride[4] = {1, 1, 1, 1};
  for (int i = 0; i < 3; ++i) {
    if (d[i].stride % 16) return cudaErrorMisalignedAddress;
    gdim[i + 1] = d[i].n > 0 ? d[i].n : 1;
    gstride[i] = d[i].stride;
    if (d[i].role == 0) {
      box[i + 1] = box_rows;
      dims->row = i + 1;
    } else if (d[i].role == 1) {
      dims->head = i + 1;
    } else {
      dims->batch = i + 1;
    }
  }
  const CUresult r = encode(map, dt, 4, const_cast<void*>(ptr), gdim, gstride, box, estride,
                            CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                            CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

template <int DP>
constexpr size_t smem_bytes() {
  return 1024 + static_cast<size_t>(DP / ATOM) * 128 * (BQ + 2 * STAGES * BK) +
         8 * (1 + 2 * STAGES);
}

template <typename T, int DP>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, int B, int H, int KV,
                   int Sq, int Sk, int D, Strides qst, Strides kst, Strides vst, Strides ost,
                   float scale, int causal, int qoff, cudaStream_t stream) {
  const CUtensorMapDataType dt = std::is_same<T, __half>::value
                                     ? CU_TENSOR_MAP_DATA_TYPE_FLOAT16
                                     : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  CUtensorMap mq, mk, mv;
  MapDims dq{}, dk{}, dv{};
  const int rows_k = Sk > 0 ? Sk : 1;  // no tile is loaded when Sk == 0
  cudaError_t err = make_map(&mq, &dq, q, dt, D, Sq, H, B, qst.s, qst.h, qst.b, BQ);
  if (err == cudaSuccess) err = make_map(&mk, &dk, k, dt, D, rows_k, KV, B, kst.s, kst.h, kst.b, BK);
  if (err == cudaSuccess) err = make_map(&mv, &dv, v, dt, D, rows_k, KV, B, vst.s, vst.h, vst.b, BK);
  if (err != cudaSuccess) return err;
  if (reinterpret_cast<uintptr_t>(o) % 4 || ost.s % 2 || ost.h % 2 || ost.b % 2)
    return cudaErrorMisalignedAddress;  // the epilogue stores element pairs
  constexpr size_t smem = smem_bytes<DP>();
  static_assert(smem <= 232448, "one CTA's shared memory on Hopper");
  auto kern = flash_tc_kernel<T, DP>;
  err = allow_smem(kern, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(B * H, (Sq + BQ - 1) / BQ);
  kern<<<grid, NT, smem, stream>>>(mq, mk, mv, static_cast<T*>(o), dq, dk, dv, H, H / KV, Sq, Sk,
                                   D, ost, scale * LOG2E, causal, qoff);
  return cudaGetLastError();
}

}  // namespace tc

template <typename T>
cudaError_t by_dim_tc(int D, const void* q, const void* k, const void* v, void* o, int B, int H,
                      int KV, int Sq, int Sk, Strides qst, Strides kst, Strides vst, Strides ost,
                      float scale, int causal, int qoff, cudaStream_t st) {
  switch (D) {
    case 16:
    case 32:
    case 64:  // D < 64 rides in a 64-wide tile, zero-filled by the copy
      return tc::launch<T, 64>(q, k, v, o, B, H, KV, Sq, Sk, D, qst, kst, vst, ost, scale, causal,
                               qoff, st);
    case 128:
      return tc::launch<T, 128>(q, k, v, o, B, H, KV, Sq, Sk, D, qst, kst, vst, ost, scale, causal,
                                qoff, st);
    default:
      return cudaErrorInvalidValue;
  }
}

cudaError_t by_dim_simt(int D, const void* q, const void* k, const void* v, void* o, int B, int H,
                        int KV, int Sq, int Sk, Strides qst, Strides kst, Strides vst, Strides ost,
                        float scale, int causal, int qoff, cudaStream_t st) {
  switch (D) {
    case 16:
      return simt::launch<16>(q, k, v, o, B, H, KV, Sq, Sk, qst, kst, vst, ost, scale, causal,
                              qoff, st);
    case 32:
      return simt::launch<32>(q, k, v, o, B, H, KV, Sq, Sk, qst, kst, vst, ost, scale, causal,
                              qoff, st);
    case 64:
      return simt::launch<64>(q, k, v, o, B, H, KV, Sq, Sk, qst, kst, vst, ost, scale, causal,
                              qoff, st);
    case 128:
      return simt::launch<128>(q, k, v, o, B, H, KV, Sq, Sk, qst, kst, vst, ost, scale, causal,
                              qoff, st);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// q (B, H, Sq, D), k/v (B, KV, Sk, D), o like q, each addressed by its
// (batch, head, row) element strides with D contiguous; causal needs
// Sk >= Sq (bottom-right aligned).  bf16/f16 take the
// tensor-core kernel (pointers and non-unit strides 16-byte aligned), f32
// the SIMT kernel.  Returns the launch's cudaError_t.
extern "C" int sct_flash_attention_fwd(const void* q, const void* k, const void* v, void* o,
                                       int dtype, int B, int H, int KV, int Sq, int Sk,
                                       int D, long long q_sb, long long q_sh, long long q_ss,
                                       long long k_sb, long long k_sh, long long k_ss,
                                       long long v_sb, long long v_sh, long long v_ss,
                                       long long o_sb, long long o_sh, long long o_ss,
                                       float scale, int causal, void* stream) {
  if (B * H == 0 || Sq == 0) return cudaSuccess;
  if (KV <= 0 || H % KV) return cudaErrorInvalidValue;
  if (causal && Sk < Sq) return cudaErrorInvalidValue;
  const int qoff = causal ? Sk - Sq : 0;  // bottom-right aligned causal mask
  const Strides qst{q_sb, q_sh, q_ss}, kst{k_sb, k_sh, k_ss}, vst{v_sb, v_sh, v_ss},
      ost{o_sb, o_sh, o_ss};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case F32:
      return by_dim_simt(D, q, k, v, o, B, H, KV, Sq, Sk, qst, kst, vst, ost, scale, causal, qoff,
                         st);
    case F16:
      return by_dim_tc<__half>(D, q, k, v, o, B, H, KV, Sq, Sk, qst, kst, vst, ost, scale, causal,
                               qoff, st);
    case BF16:
      return by_dim_tc<__nv_bfloat16>(D, q, k, v, o, B, H, KV, Sq, Sk, qst, kst, vst, ost, scale,
                                      causal, qoff, st);
    default:
      return cudaErrorInvalidValue;
  }
}

extern "C" const char* sct_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
