// Prefill (flash) attention for Hopper, sm_90a. Plain C interface, loaded
// with ctypes by repro_torch/kernels/flash_attention.py.
//
// Replaces the TPU kernel src/repro/kernels/flash_attention.py::
// flash_attention_bhsd (_flash_kernel): causal or full GQA attention with
// an online softmax (running max, sum and accumulator in f32), keys past
// the sequence masked, kv tiles entirely above the diagonal skipped, the
// row sum clamped at 1e-30, masked scores set to -1e30.
//
// Layout: q (B, S, Hq, D), k/v (B, S, Hkv, D) and o (B, S, Hq, D), each
// addressed through its own element strides (the last dim must be
// contiguous), so the model's tensors go in without a transpose or copy.
// q head h reads kv head h / G (G = Hq / Hkv): GQA by indexing.
//
// Bound on the H100 (3.35 TB/s, 989 TFLOP/s bf16): at the serving shape
// B=32, S=128, Hq=14, Hkv=2, D=64 the call moves ~16.8 MB (q and o 7.3 MB
// each, k+v 2.1 MB), ~5.0 us, against ~0.94 GFLOP of causal work, ~1 us:
// bytes bound. Each q and k/v element is read from device memory once per
// block that needs it; the kv tile is staged once in shared memory and
// shared by the block's 64 query rows.
//
// Design (simple first version; mma.sync / wgmma / TMA are later work):
// one block of 256 threads per (64-row query tile, batch * q head). Four
// adjacent lanes own one query row, each lane holding a quarter of the
// head dim (as float4 chunks) of q and of the f32 accumulator. A kv tile
// of BK rows is converted to f32 into shared memory; each lane computes
// its partial dot products, two xor-shuffles finish them, and the four
// lanes then run the same online-softmax update on the tile's BK scores.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;
constexpr int kBlockQ = 64;
constexpr int kLanesPerRow = 4;
constexpr int kThreads = kBlockQ * kLanesPerRow;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

template <typename T, int D, int BK>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o,
                 int S, int Hq, int group,
                 int64_t q_sb, int64_t q_ss, int64_t q_sh,
                 int64_t k_sb, int64_t k_ss, int64_t k_sh,
                 int64_t v_sb, int64_t v_ss, int64_t v_sh,
                 int64_t o_sb, int64_t o_ss, int64_t o_sh,
                 float scale, int causal) {
  constexpr int D4 = D / 4;                   // float4 chunks per row
  constexpr int C = D4 / kLanesPerRow;        // float4 chunks per lane
  __shared__ float4 ks[BK][D4];
  __shared__ float4 vs[BK][D4];

  const int bh = blockIdx.y;
  const int b = bh / Hq;
  const int h = bh - b * Hq;
  const int hkv = h / group;
  const int q0 = blockIdx.x * kBlockQ;
  const int tid = threadIdx.x;
  const int row = tid / kLanesPerRow;
  const int sub = tid - row * kLanesPerRow;
  const int qpos = q0 + row;

  const T* qb = q + b * q_sb + h * q_sh;
  const T* kb = k + b * k_sb + hkv * k_sh;
  const T* vb = v + b * v_sb + hkv * v_sh;

  // lane `sub` owns chunks sub, sub + 4, ... (dims 4c .. 4c+3 of chunk c):
  // the four lanes of a row read 64 consecutive bytes of a shared-memory
  // row, and the eight rows of a warp read the same addresses (broadcast)
  float4 qr[C];
  float4 acc[C];
#pragma unroll
  for (int i = 0; i < C; ++i) {
    const int d = 4 * (sub + kLanesPerRow * i);
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (qpos < S) {
      const T* p = qb + qpos * q_ss + d;
      x = make_float4(to_f32(p[0]), to_f32(p[1]), to_f32(p[2]), to_f32(p[3]));
    }
    qr[i] = x;
    acc[i] = make_float4(0.f, 0.f, 0.f, 0.f);
  }
  float m = kNegInf;
  float l = 0.f;

  // causal: kv tiles starting past this query tile's last row are skipped
  const int k_end = causal ? min(S, q0 + kBlockQ) : S;
  for (int k0 = 0; k0 < k_end; k0 += BK) {
    __syncthreads();  // the previous tile is no longer read
    float* ksf = reinterpret_cast<float*>(ks);
    float* vsf = reinterpret_cast<float*>(vs);
    for (int idx = tid; idx < BK * D; idx += kThreads) {
      const int j = idx / D;
      const int d = idx - j * D;
      const int kp = k0 + j;
      float kx = 0.f, vx = 0.f;
      if (kp < S) {
        kx = to_f32(kb[kp * k_ss + d]);
        vx = to_f32(vb[kp * v_ss + d]);
      }
      ksf[idx] = kx;
      vsf[idx] = vx;
    }
    __syncthreads();

    float s[BK];
    float tile_max = kNegInf;
#pragma unroll
    for (int j = 0; j < BK; ++j) {
      float part = 0.f;
#pragma unroll
      for (int i = 0; i < C; ++i) {
        const float4 kk = ks[j][sub + kLanesPerRow * i];
        part = fmaf(qr[i].x, kk.x, part);
        part = fmaf(qr[i].y, kk.y, part);
        part = fmaf(qr[i].z, kk.z, part);
        part = fmaf(qr[i].w, kk.w, part);
      }
      part += __shfl_xor_sync(0xffffffffu, part, 1);
      part += __shfl_xor_sync(0xffffffffu, part, 2);
      const int kp = k0 + j;
      const bool ok = kp < S && (!causal || kp <= qpos);
      const float sc = ok ? part * scale : kNegInf;
      s[j] = sc;
      tile_max = fmaxf(tile_max, sc);
    }

    const float m_new = fmaxf(m, tile_max);
    const float alpha = expf(m - m_new);
#pragma unroll
    for (int i = 0; i < C; ++i) {
      acc[i].x *= alpha; acc[i].y *= alpha; acc[i].z *= alpha; acc[i].w *= alpha;
    }
    float psum = 0.f;
#pragma unroll
    for (int j = 0; j < BK; ++j) {
      const float p = expf(s[j] - m_new);
      psum += p;
#pragma unroll
      for (int i = 0; i < C; ++i) {
        const float4 vv = vs[j][sub + kLanesPerRow * i];
        acc[i].x = fmaf(p, vv.x, acc[i].x);
        acc[i].y = fmaf(p, vv.y, acc[i].y);
        acc[i].z = fmaf(p, vv.z, acc[i].z);
        acc[i].w = fmaf(p, vv.w, acc[i].w);
      }
    }
    l = l * alpha + psum;
    m = m_new;
  }

  if (qpos < S) {
    const float denom = fmaxf(l, 1e-30f);
    T* ob = o + b * o_sb + qpos * o_ss + h * o_sh;
#pragma unroll
    for (int i = 0; i < C; ++i) {
      const int d = 4 * (sub + kLanesPerRow * i);
      ob[d + 0] = from_f32<T>(acc[i].x / denom);
      ob[d + 1] = from_f32<T>(acc[i].y / denom);
      ob[d + 2] = from_f32<T>(acc[i].z / denom);
      ob[d + 3] = from_f32<T>(acc[i].w / denom);
    }
  }
}

template <typename T, int D>
void launch(const void* q, const void* k, const void* v, void* o,
            int B, int S, int Hq, int Hkv, int causal,
            const long long* qs, const long long* ks, const long long* vs,
            const long long* os, cudaStream_t stream) {
  // 32 KB of f32 kv tile in shared memory at every head dim
  constexpr int BK = D <= 64 ? 64 : 32;
  dim3 grid((S + kBlockQ - 1) / kBlockQ, B * Hq);
  flash_fwd_kernel<T, D, BK><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), S, Hq, Hq / Hkv,
      qs[0], qs[1], qs[2], ks[0], ks[1], ks[2], vs[0], vs[1], vs[2],
      os[0], os[1], os[2], 1.0f / sqrtf(static_cast<float>(D)), causal);
}

template <typename T>
int dispatch_d(int D, const void* q, const void* k, const void* v, void* o,
               int B, int S, int Hq, int Hkv, int causal,
               const long long* qs, const long long* ks, const long long* vs,
               const long long* os, cudaStream_t stream) {
  switch (D) {
    case 16: launch<T, 16>(q, k, v, o, B, S, Hq, Hkv, causal, qs, ks, vs, os, stream); break;
    case 32: launch<T, 32>(q, k, v, o, B, S, Hq, Hkv, causal, qs, ks, vs, os, stream); break;
    case 64: launch<T, 64>(q, k, v, o, B, S, Hq, Hkv, causal, qs, ks, vs, os, stream); break;
    case 128: launch<T, 128>(q, k, v, o, B, S, Hq, Hkv, causal, qs, ks, vs, os, stream); break;
    default: return -2;
  }
  return 0;
}

}  // namespace

extern "C" {

// Returns 0 on success, a negative code for arguments the kernel does not
// take (-1 bad head counts or sizes, -2 head dim, -3 dtype), else the
// cudaError_t of the launch.
int flash_attention_fwd(const void* q, const void* k, const void* v, void* o,
                        int dtype, int B, int S, int Hq, int Hkv, int D,
                        int causal, long long q_sb, long long q_ss,
                        long long q_sh, long long k_sb, long long k_ss,
                        long long k_sh, long long v_sb, long long v_ss,
                        long long v_sh, long long o_sb, long long o_ss,
                        long long o_sh, int device, void* stream) {
  if (B <= 0 || S <= 0 || Hkv <= 0 || Hq % Hkv != 0 || B * Hq > 65535) return -1;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long qs[3] = {q_sb, q_ss, q_sh};
  const long long ks[3] = {k_sb, k_ss, k_sh};
  const long long vs[3] = {v_sb, v_ss, v_sh};
  const long long os[3] = {o_sb, o_ss, o_sh};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int rc;
  if (dtype == 0) {
    rc = dispatch_d<float>(D, q, k, v, o, B, S, Hq, Hkv, causal, qs, ks, vs, os, st);
  } else if (dtype == 1) {
    rc = dispatch_d<__nv_bfloat16>(D, q, k, v, o, B, S, Hq, Hkv, causal, qs, ks, vs, os, st);
  } else {
    return -3;
  }
  if (rc != 0) return rc;
  return static_cast<int>(cudaGetLastError());
}

const char* flash_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
