// Decode attention for Hopper, sm_90a: one query token per sequence
// against the KV cache. Plain C interface, loaded with ctypes by
// repro_torch/kernels/decode_attention.py.
//
// Replaces the TPU kernel src/repro/kernels/decode_attention.py::
// decode_attention_bhgd (_decode_kernel): for each (batch, kv head) the G
// query heads that share the kv head go against that head's cache rows
// [0, len) with an online softmax in f32; rows past the length are masked
// (-1e30) and tiles past it are skipped; the row sum is clamped at 1e-30,
// so a length of 0 gives zeros, as the TPU kernel does.
//
// Layout: q (B, 1, Hq, D) and the cache of one layer (B, S_max, Hkv, D),
// each through its own element strides (last dim contiguous): the cache is
// read where the model keeps it, with no per-step transpose or copy. The
// lengths are int32 on the device (len_stride 0 broadcasts one length to
// the batch), so the host never waits on the length.
//
// Bound on the H100 (3.35 TB/s): at the serving shape B=32, S_max=144,
// Hkv=2, D=64 the valid cache is at most ~2.4 MB of bf16 k+v, ~0.7 us, and
// the work is 4·Hq·D flops per cached row: bytes bound, and below the
// launch latency. Each (batch, kv head) block streams its cache rows once
// for all G query heads.
//
// Design (simple first version; a split of S across blocks is later
// work): one block per (batch, kv head) with one warp per query head
// (any G up to 32). A tile of 32·KPL cache rows is staged in f32 in
// shared memory, rows padded by one float so lanes reading different rows
// hit different banks; lane t scores rows t, t+32, ..; warp shuffles
// give the tile max and sum; the accumulator is spread over the lanes by
// head dim.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x = fmaxf(x, __shfl_xor_sync(kFull, x, off));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(kFull, x, off);
  return x;
}

template <typename T, int D, int KPL>
__global__ void __launch_bounds__(1024)
decode_kernel(const T* __restrict__ q, const T* __restrict__ k,
              const T* __restrict__ v, const int* __restrict__ lengths,
              int len_stride, T* __restrict__ o, int S_max, int Hkv, int group,
              int64_t q_sb, int64_t q_sh,
              int64_t k_sb, int64_t k_ss, int64_t k_sh,
              int64_t v_sb, int64_t v_ss, int64_t v_sh,
              int64_t o_sb, int64_t o_sh, float scale) {
  constexpr int BK = 32 * KPL;          // cache rows per tile
  constexpr int DP = D + 1;             // padded shared-memory row
  constexpr int DL = (D + 31) / 32;     // accumulator dims per lane
  extern __shared__ float smem[];
  float* ks = smem;                     // [BK][DP]
  float* vs = smem + BK * DP;           // [BK][DP]
  float* qs = smem + 2 * BK * DP;       // [group][D]

  const int b = blockIdx.x / Hkv;
  const int hkv = blockIdx.x - b * Hkv;
  const int tid = threadIdx.x;
  const int nthreads = blockDim.x;
  const int g = tid / 32;
  const int lane = tid - g * 32;
  const int h = hkv * group + g;

  int len = lengths[b * len_stride];
  len = min(max(len, 0), S_max);

  const T* kb = k + b * k_sb + hkv * k_sh;
  const T* vb = v + b * v_sb + hkv * v_sh;
  for (int idx = tid; idx < group * D; idx += nthreads) {
    const int gg = idx / D;
    const int d = idx - gg * D;
    qs[idx] = to_f32(q[b * q_sb + (hkv * group + gg) * q_sh + d]);
  }

  float acc[DL];
#pragma unroll
  for (int i = 0; i < DL; ++i) acc[i] = 0.f;
  float m = kNegInf;
  float l = 0.f;
  const float* qg = qs + g * D;

  for (int k0 = 0; k0 < len; k0 += BK) {
    __syncthreads();  // q staged / previous tile no longer read
    for (int idx = tid; idx < BK * D; idx += nthreads) {
      const int j = idx / D;
      const int d = idx - j * D;
      const int kp = k0 + j;
      float kx = 0.f, vx = 0.f;
      if (kp < len) {
        kx = to_f32(kb[kp * k_ss + d]);
        vx = to_f32(vb[kp * v_ss + d]);
      }
      ks[j * DP + d] = kx;
      vs[j * DP + d] = vx;
    }
    __syncthreads();

    float s[KPL];
    float tile_max = kNegInf;
#pragma unroll
    for (int t = 0; t < KPL; ++t) {
      const int j = lane + 32 * t;
      const float* kr = ks + j * DP;
      float dot = 0.f;
#pragma unroll
      for (int d = 0; d < D; ++d) dot = fmaf(qg[d], kr[d], dot);
      const float sc = (k0 + j < len) ? dot * scale : kNegInf;
      s[t] = sc;
      tile_max = fmaxf(tile_max, sc);
    }
    tile_max = warp_max(tile_max);
    const float m_new = fmaxf(m, tile_max);
    const float alpha = expf(m - m_new);
    float p[KPL];
    float psum = 0.f;
#pragma unroll
    for (int t = 0; t < KPL; ++t) {
      p[t] = expf(s[t] - m_new);
      psum += p[t];
    }
    psum = warp_sum(psum);
#pragma unroll
    for (int i = 0; i < DL; ++i) acc[i] *= alpha;
#pragma unroll
    for (int t = 0; t < KPL; ++t) {
#pragma unroll 8
      for (int src = 0; src < 32; ++src) {
        const float pj = __shfl_sync(kFull, p[t], src);
        const float* vr = vs + (src + 32 * t) * DP;
#pragma unroll
        for (int i = 0; i < DL; ++i) {
          const int d = lane + 32 * i;
          if (d < D) acc[i] = fmaf(pj, vr[d], acc[i]);
        }
      }
    }
    l = l * alpha + psum;
    m = m_new;
  }

  const float denom = fmaxf(l, 1e-30f);
  T* ob = o + b * o_sb + h * o_sh;
#pragma unroll
  for (int i = 0; i < DL; ++i) {
    const int d = lane + 32 * i;
    if (d < D) ob[d] = from_f32<T>(acc[i] / denom);
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, const int* lengths,
           int len_stride, void* o, int B, int S_max, int Hq, int Hkv,
           const long long* qs, const long long* ks, const long long* vs,
           const long long* os, cudaStream_t stream) {
  // 64 cache rows a tile (32 at D=128): ~33 KB of f32 tiles in shared memory
  constexpr int KPL = D <= 64 ? 2 : 1;
  constexpr int BK = 32 * KPL;
  const int group = Hq / Hkv;
  const size_t smem = sizeof(float) * (2 * BK * (D + 1) + group * D);
  if (smem > 48 * 1024) return -1;
  decode_kernel<T, D, KPL><<<B * Hkv, 32 * group, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), lengths, len_stride, static_cast<T*>(o),
      S_max, Hkv, group, qs[0], qs[1], ks[0], ks[1], ks[2], vs[0], vs[1],
      vs[2], os[0], os[1], 1.0f / sqrtf(static_cast<float>(D)));
  return 0;
}

template <typename T>
int dispatch_d(int D, const void* q, const void* k, const void* v,
               const int* lengths, int len_stride, void* o, int B, int S_max,
               int Hq, int Hkv, const long long* qs, const long long* ks,
               const long long* vs, const long long* os, cudaStream_t st) {
  switch (D) {
    case 16: return launch<T, 16>(q, k, v, lengths, len_stride, o, B, S_max, Hq, Hkv, qs, ks, vs, os, st);
    case 32: return launch<T, 32>(q, k, v, lengths, len_stride, o, B, S_max, Hq, Hkv, qs, ks, vs, os, st);
    case 64: return launch<T, 64>(q, k, v, lengths, len_stride, o, B, S_max, Hq, Hkv, qs, ks, vs, os, st);
    case 128: return launch<T, 128>(q, k, v, lengths, len_stride, o, B, S_max, Hq, Hkv, qs, ks, vs, os, st);
    default: return -2;
  }
}

}  // namespace

extern "C" {

// Returns 0 on success, a negative code for arguments the kernel does not
// take (-1 bad head counts or sizes, -2 head dim, -3 dtype), else the
// cudaError_t of the launch.
int decode_attention_fwd(const void* q, const void* k, const void* v,
                         const void* lengths, int len_stride, void* o,
                         int dtype, int B, int S_max, int Hq, int Hkv, int D,
                         long long q_sb, long long q_sh, long long k_sb,
                         long long k_ss, long long k_sh, long long v_sb,
                         long long v_ss, long long v_sh, long long o_sb,
                         long long o_sh, int device, void* stream) {
  if (B <= 0 || S_max <= 0 || Hkv <= 0 || Hq % Hkv != 0 || Hq / Hkv > 32) return -1;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long qs[2] = {q_sb, q_sh};
  const long long ks[3] = {k_sb, k_ss, k_sh};
  const long long vs[3] = {v_sb, v_ss, v_sh};
  const long long os[2] = {o_sb, o_sh};
  const int* lens = static_cast<const int*>(lengths);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int rc;
  if (dtype == 0) {
    rc = dispatch_d<float>(D, q, k, v, lens, len_stride, o, B, S_max, Hq, Hkv, qs, ks, vs, os, st);
  } else if (dtype == 1) {
    rc = dispatch_d<__nv_bfloat16>(D, q, k, v, lens, len_stride, o, B, S_max, Hq, Hkv, qs, ks, vs, os, st);
  } else {
    return -3;
  }
  if (rc != 0) return rc;
  return static_cast<int>(cudaGetLastError());
}

const char* decode_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
