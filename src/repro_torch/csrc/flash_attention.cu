// Flash attention: causal online-softmax attention with GQA, one launch per
// attention call.
//
// Replaces the TPU kernel repro/kernels/flash_attention.py::flash_attention
// (body _flash_kernel, pl.pallas_call at flash_attention.py:109), whose grid
// (B*H, q-blocks, kv-blocks) walks the kv axis in order and carries the f32
// accumulator, row max and row sum across it in VMEM scratch.
//
// What it computes, for query row i of head h (kv head h / (H / Hkv)):
//   s_j   = (scale * q_i) . k_j      (q scaled in f32 before the product)
//   vis_j = j < Sk && (!causal || j <= i + (Sk - Sq))
//   o_i   = sum_j vis_j exp(s_j - m) v_j / sum_j vis_j exp(s_j - m)
// with m the running max of the visible scores, f32 throughout, and o_i = 0
// for a row with no visible key (Sq > Sk); the output has q's type.
//
// What bounds it on the H100: operations.  At phi3-mini's shape (B*H = 32,
// S = 4096, D = 96, causal) it does 4 * B*H * S^2 * D / 2 = 103 GFLOP,
// 0.104 ms at the 989 TFLOP/s bf16 tensor-core peak, against 0.03 ms for
// its ~100 MB of q, k, v and o at 3.35 TB/s.
//
// What this design does about it: little yet.  It is the simple, exact
// form on the CUDA cores in f32: one block per (b*h, tile of 64 query
// rows); four threads share a row, each holding a quarter of q's and of the
// accumulator's D values in registers (dims t, t+4, t+8, ... so that the
// four lanes read neighbouring shared-memory banks), and a score is their
// partial dot products summed by two warp shuffles.  The kv grid axis of
// the TPU kernel is a loop inside the block over tiles of 32 keys, staged
// in shared memory as f32 (bf16 is widened on the load); the online-softmax
// state (m, l, acc) stays in f32 registers, rescaled once per tile.  Tiles
// wholly above the causal diagonal are skipped, which is exact (they add
// p = 0, alpha = 1).  Ragged edges are masked, not padded.  GQA indexes the
// kv head directly; nothing is repeated in memory.  q, k, v and o are read
// and written through their (batch, head, row) strides with a unit stride
// on D, so the [B, S, H, D] projections of the model need no copy.  The
// tensor-core (mma.sync / wgmma) and TMA redesign is later work.
//
// The error-string entry point (pr_error_string) comes from common.cuh.

#include <cuda_bf16.h>

#include "common.cuh"

namespace {

constexpr float kNegInf = -1e30f;   // the reference's NEG_INF
constexpr int kTpr = 4;             // threads per query row
constexpr int kBq = 64;             // query rows per block
constexpr int kBk = 32;             // keys per shared-memory tile
constexpr int kThreads = kBq * kTpr;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

struct Strides {
  long long b, h, s;
};

template <typename T, int D>
__global__ void __launch_bounds__(kThreads) flash_fwd_kernel(
    const T* __restrict__ q, const T* __restrict__ k,
    const T* __restrict__ v, T* __restrict__ o, int H, int Hkv, int Sq,
    int Sk, int causal, float scale, Strides qs, Strides ks, Strides vs,
    Strides os) {
  constexpr int DS = D / kTpr;      // D values per thread
  __shared__ float sk[kBk][D];
  __shared__ float sv[kBk][D];

  const int tid = threadIdx.x;
  const int r = tid / kTpr;         // row within the tile
  const int t = tid % kTpr;         // part of the row
  const int bh = blockIdx.y;
  const int b = bh / H, h = bh % H;
  const int hk = h / (H / Hkv);
  const int q0 = blockIdx.x * kBq;
  const int qi = q0 + r;
  const int off = Sk - Sq;          // causal offset (bottom-right aligned)

  const T* qrow = q + b * qs.b + h * qs.h + (long long)qi * qs.s;
  const T* kb = k + b * ks.b + hk * ks.h;
  const T* vb = v + b * vs.b + hk * vs.h;

  float qr[DS], acc[DS];
#pragma unroll
  for (int i = 0; i < DS; ++i) {
    qr[i] = qi < Sq ? to_f32(qrow[i * kTpr + t]) * scale : 0.f;
    acc[i] = 0.f;
  }
  float m = kNegInf, l = 0.f;

  int kv_end = Sk;
  if (causal) kv_end = min(Sk, q0 + kBq + off);   // last visible key + 1
  for (int k0 = 0; k0 < kv_end; k0 += kBk) {
    __syncthreads();                // the previous tile is consumed
    for (int idx = tid; idx < kBk * D; idx += kThreads) {
      const int j = idx / D, d = idx % D;
      const int key = k0 + j;
      const bool in = key < Sk;
      sk[j][d] = in ? to_f32(kb[(long long)key * ks.s + d]) : 0.f;
      sv[j][d] = in ? to_f32(vb[(long long)key * vs.s + d]) : 0.f;
    }
    __syncthreads();

    float s[kBk];
    float m_tile = kNegInf;
#pragma unroll
    for (int j = 0; j < kBk; ++j) {
      float part = 0.f;
#pragma unroll
      for (int i = 0; i < DS; ++i)
        part = fmaf(qr[i], sk[j][i * kTpr + t], part);
      part += __shfl_xor_sync(0xffffffffu, part, 1);
      part += __shfl_xor_sync(0xffffffffu, part, 2);
      const int key = k0 + j;
      const bool vis = key < Sk && (!causal || key <= qi + off);
      s[j] = vis ? part : kNegInf;
      m_tile = fmaxf(m_tile, s[j]);
    }
    const float m_new = fmaxf(m, m_tile);
    const float alpha = expf(m - m_new);
    l *= alpha;
#pragma unroll
    for (int i = 0; i < DS; ++i) acc[i] *= alpha;
#pragma unroll
    for (int j = 0; j < kBk; ++j) {
      const int key = k0 + j;
      const bool vis = key < Sk && (!causal || key <= qi + off);
      const float p = vis ? expf(s[j] - m_new) : 0.f;
      l += p;
#pragma unroll
      for (int i = 0; i < DS; ++i)
        acc[i] = fmaf(p, sv[j][i * kTpr + t], acc[i]);
    }
    m = m_new;
  }

  if (qi < Sq) {
    T* orow = o + b * os.b + h * os.h + (long long)qi * os.s;
    const float inv = l > 0.f ? 1.f / l : 0.f;
#pragma unroll
    for (int i = 0; i < DS; ++i)
      store(orow + i * kTpr + t, l > 0.f ? acc[i] * inv : 0.f);
  }
}

struct Args {
  const void *q, *k, *v;
  void* o;
  int B, H, Hkv, Sq, Sk, causal;
  float scale;
  Strides qs, ks, vs, os;
};

template <typename T, int D>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  dim3 grid((a.Sq + kBq - 1) / kBq, a.B * a.H);
  flash_fwd_kernel<T, D><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), static_cast<T*>(a.o), a.H, a.Hkv, a.Sq,
      a.Sk, a.causal, a.scale, a.qs, a.ks, a.vs, a.os);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_d(int D, const Args& a, cudaStream_t st) {
  switch (D) {
    case 16: return launch<T, 16>(a, st);
    case 32: return launch<T, 32>(a, st);
    case 64: return launch<T, 64>(a, st);
    case 96: return launch<T, 96>(a, st);
    case 128: return launch<T, 128>(a, st);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype 0: float32, 1: bfloat16.  Strides are in elements; D's is 1.
extern "C" int flash_attention_fwd(
    const void* q, const void* k, const void* v, void* o, int B, int H,
    int Hkv, int Sq, int Sk, int D, int dtype, int causal, float scale,
    long long q_sb, long long q_sh, long long q_ss, long long k_sb,
    long long k_sh, long long k_ss, long long v_sb, long long v_sh,
    long long v_ss, long long o_sb, long long o_sh, long long o_ss,
    void* stream) {
  if (B == 0 || H == 0 || Sq == 0) return 0;
  if (Hkv <= 0 || H % Hkv != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const Args a{q, k, v, o, B, H, Hkv, Sq, Sk, causal, scale,
               {q_sb, q_sh, q_ss}, {k_sb, k_sh, k_ss}, {v_sb, v_sh, v_ss},
               {o_sb, o_sh, o_ss}};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 0)
    err = dispatch_d<float>(D, a, st);
  else if (dtype == 1)
    err = dispatch_d<__nv_bfloat16>(D, a, st);
  else
    err = cudaErrorInvalidValue;
  return static_cast<int>(err);
}
