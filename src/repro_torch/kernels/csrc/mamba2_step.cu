// Mamba-2 decode step (Zamba2's one-token mixer) for Hopper, sm_90a. Plain C
// interface, loaded with ctypes by repro_torch/kernels/mamba2_step.py.
//
// Replaces no TPU kernel: the JAX package decodes through plain jnp ops
// (src/repro/models/ssm.py::ssd_step and the mixer around it), which XLA
// fuses on the TPU. In eager PyTorch the same step is ~40 small kernels a
// layer and five passes over the f32 state; this file is that step as two
// launches. From the in_proj output zx = [z | x | B | C | dt] of one token
// per row, with the conv state (B, W-1, conv_dim) and the SSM state
// h (B, H, P, N) f32 updated in place, to the gated, normalised y that
// out_proj reads:
//
//   xbc  = SiLU(conv(state ++ [x | B | C]) + bias)          (model dtype)
//   dt   = softplus(dt_raw + dt_bias);  decay = exp(dt * -exp(a_log))
//   h    = h * decay + (dt * x) (x) B_g                      (f32)
//   y    = (C_g . h + D * x) * SiLU(z)                       (f32)
//   out  = y * rsqrt(mean over the group's channels of y^2 + eps) * scale
//
// with head h reading B and C of group h / (H / G) (G = 1 is Zamba2-1.2B's
// shared B and C, G = 2 Zamba2-7B's). Every rounding point is the plain
// path's (models/ssm.py::mamba2_mix, step=True): the conv's taps multiply
// and add in the model dtype in _causal_conv's order, each op rounded;
// SiLU rounds to the model dtype; dt, the decay, the state, y and the norm
// stay f32; the output rounds once. Products and sums go through __fmul_rn
// and __fadd_rn, so nvcc fuses none of them into an FMA the plain path does
// not have (only C . h, a cuBLAS product there, sums in its own order).
//
// Bound on the H100 (3.35 TB/s): the state. At Zamba2-7B's bucket 8 (H 112,
// P = N = 64) a layer reads and writes 14.7 MB of f32 state each way,
// 29.4 MB, ~8.8 us; zx, the conv state and the output add ~0.3 MB. The
// plain path passed over the state five times (decay, inject, C . h).
//
// mamba_step_kernel: one block of 128 threads per (row, head, slice of P).
// It convolves its x channels and its group's B and C channels, rolls its
// own x channels' conv state, then streams its (P / splits) x N slice of
// the state once: every thread issues all its 16-byte loads first (up to 8
// a thread), updates, writes back and reduces C . h over the N / 4 lanes of
// each state row with warp shuffles. It writes the gated y (f32) and the
// slice's sum of y^2 to scratch. At bucket 8 that is 896 blocks of 16 KB,
// one wave on 132 SMs; at smaller buckets the launcher splits P across
// blocks (mamba2_step.py::splits, by shape only) so that about 528 blocks
// still keep enough bytes in flight.
//
// mamba_gated_norm_kernel: one block per (channel chunk, group, row) adds
// the group's slice sums in a fixed order (no atomics: a replayed graph and
// per-token eager give the same bits), normalises and rounds its channels
// once, and rolls the conv state of the group's B and C channels. Those are
// read by every head of the group in the first kernel, so no block there may
// overwrite them; the second launch runs after all of them.
//
// The conv width is Mamba-2's d_conv, 4, fixed at compile time. The entry
// functions are named mamba_*: profile readers map ssd_* names to the SSD
// scan, and these must not be counted as its launches.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kStepThreads = 128;
// blocks of the step kernel an SM must hold (registers capped to fit): 896
// blocks at Zamba2-7B's bucket 8 are then one wave on 132 SMs
constexpr int kStepBlocksPerSM = 7;
constexpr int kNormThreads = 256;
constexpr int kWidth = 4;  // conv taps, Mamba-2's d_conv

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// x rounded to T and read back, as a PyTorch op on T tensors stores it
template <typename T> __device__ __forceinline__ float round_to(float x) {
  return to_f32(from_f32<T>(x));
}

// PyTorch's f32 SiLU and softplus (beta 1, threshold 20)
__device__ __forceinline__ float silu(float x) {
  return __fdiv_rn(x, __fadd_rn(1.0f, expf(-x)));
}
__device__ __forceinline__ float softplus(float x) {
  return x > 20.0f ? x : log1pf(expf(x));
}

struct StepArgs {
  const void* zx;        // (B, 1, 2 d_inner + 2 G N + H), row stride zx_sb
  const void* conv_w;    // (W, conv_dim), row stride cw_sw
  const void* conv_b;    // (conv_dim,)
  const float* dt_bias;  // (H,)
  const float* a_log;    // (H,)
  const float* d_skip;   // (H,)
  const void* scale;     // (d_inner,) the norm's
  float* h;              // (B, H, P, N) f32, contiguous
  void* conv_state;      // (B, W-1, conv_dim), strides cs_sb, cs_sw
  float* y;              // (B, d_inner) f32 scratch: the gated y
  float* sq;             // (B, H * splits) f32 scratch: each slice's sum of y^2
  void* out;             // (B, d_inner), contiguous
  int H, G, splits, heads_per_group, d_inner, n;
  float eps;
  long long zx_sb, cw_sw, cs_sb, cs_sw;
};

// Depthwise causal conv of channel c over its W-1 cached inputs and the
// new one, plus bias, then SiLU, as models/ssm.py::_causal_conv and
// F.silu on T tensors. full[] returns the W inputs (the rolled state is
// full[1..W-1]).
template <typename T>
__device__ __forceinline__ float conv_silu(const StepArgs& a, const T* xbc, const T* cstate,
                                           int c, float (&full)[kWidth]) {
  const T* w = static_cast<const T*>(a.conv_w);
#pragma unroll
  for (int j = 0; j < kWidth - 1; ++j) full[j] = to_f32(cstate[j * a.cs_sw + c]);
  full[kWidth - 1] = to_f32(xbc[c]);
  float acc = round_to<T>(__fmul_rn(full[0], to_f32(w[c])));
#pragma unroll
  for (int j = 1; j < kWidth; ++j) {
    const float tap = round_to<T>(__fmul_rn(full[j], to_f32(w[j * a.cw_sw + c])));
    acc = round_to<T>(__fadd_rn(acc, tap));
  }
  acc = round_to<T>(__fadd_rn(acc, to_f32(static_cast<const T*>(a.conv_b)[c])));
  return round_to<T>(silu(acc));
}

template <typename T, int P, int N>
__global__ void __launch_bounds__(kStepThreads, kStepBlocksPerSM)
mamba_step_kernel(const StepArgs a) {
  constexpr int LN = N / 4;  // lanes of one state row, a float4 each
  constexpr int kMaxItems = (P * LN + kStepThreads - 1) / kStepThreads;
  static_assert(32 % LN == 0, "a state row's lanes lie in one warp");
  __shared__ float xs[P], bs[N], cs[N];
  __shared__ float warp_sq[kStepThreads / 32];

  const int b = blockIdx.y;
  const int split = blockIdx.x % a.splits;
  const int head = blockIdx.x / a.splits;
  const int rows = P / a.splits;
  const int p0 = split * rows;
  const int g = head / a.heads_per_group;
  const int gn = a.G * N;
  const T* zx = static_cast<const T*>(a.zx) + b * a.zx_sb;
  const T* xbc = zx + a.d_inner;  // the conv's input channels [x | B | C]
  T* cstate = static_cast<T*>(a.conv_state) + b * a.cs_sb;

  // (1) the state slice is read once and written once: every load is
  // issued first, so its latency hides behind the conv below
  float4* hs = reinterpret_cast<float4*>(a.h) +
               (static_cast<long long>(b * a.H + head) * P + p0) * LN;
  const int items = rows * LN;
  float4 hv[kMaxItems];
#pragma unroll
  for (int k = 0; k < kMaxItems; ++k) {
    const int idx = threadIdx.x + k * kStepThreads;
    if (idx < items) hv[k] = hs[idx];
  }

  // (2) the conv and SiLU of the block's x rows and its group's B and C;
  // the x channels are this block's alone, so it rolls their conv state
  for (int i = threadIdx.x; i < rows + 2 * N; i += kStepThreads) {
    float full[kWidth];
    if (i < rows) {
      const int c = head * P + p0 + i;
      xs[i] = conv_silu<T>(a, xbc, cstate, c, full);
#pragma unroll
      for (int j = 0; j < kWidth - 1; ++j) cstate[j * a.cs_sw + c] = from_f32<T>(full[j + 1]);
    } else if (i < rows + N) {
      bs[i - rows] = conv_silu<T>(a, xbc, cstate, a.d_inner + g * N + (i - rows), full);
    } else {
      cs[i - rows - N] = conv_silu<T>(a, xbc, cstate, a.d_inner + gn + g * N + (i - rows - N),
                                      full);
    }
  }
  // (3) dt and the decay, in every thread
  const float dt = softplus(__fadd_rn(to_f32(zx[2 * a.d_inner + 2 * gn + head]),
                                      a.dt_bias[head]));
  const float decay = expf(__fmul_rn(dt, -expf(a.a_log[head])));
  const float d_skip = a.d_skip[head];

  __syncthreads();  // xs, bs, cs

  // (4) update, write back, C . h over each row's lanes, gate
  float* y = a.y + static_cast<long long>(b) * a.d_inner + head * P;
  float sq = 0.0f;
#pragma unroll
  for (int k = 0; k < kMaxItems; ++k) {
    const int idx = threadIdx.x + k * kStepThreads;
    const bool live = idx < items;  // whole rows: items is a multiple of LN
    const int r = idx / LN, n0 = 4 * (idx % LN);
    float acc = 0.0f;
    if (live) {
      const float ix = __fmul_rn(dt, xs[r]);
      float4 v = hv[k];
      v.x = __fadd_rn(__fmul_rn(v.x, decay), __fmul_rn(ix, bs[n0]));
      v.y = __fadd_rn(__fmul_rn(v.y, decay), __fmul_rn(ix, bs[n0 + 1]));
      v.z = __fadd_rn(__fmul_rn(v.z, decay), __fmul_rn(ix, bs[n0 + 2]));
      v.w = __fadd_rn(__fmul_rn(v.w, decay), __fmul_rn(ix, bs[n0 + 3]));
      hs[idx] = v;
      acc = fmaf(v.w, cs[n0 + 3], fmaf(v.z, cs[n0 + 2], fmaf(v.y, cs[n0 + 1], v.x * cs[n0])));
    }
#pragma unroll
    for (int off = LN / 2; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
    if (live && n0 == 0) {
      const int p = p0 + r;
      const float yv = __fadd_rn(acc, __fmul_rn(xs[r], d_skip));
      const float gated = __fmul_rn(yv, silu(to_f32(zx[head * P + p])));
      y[p] = gated;
      sq = __fadd_rn(sq, __fmul_rn(gated, gated));
    }
  }
  // (5) the slice's sum of y^2, in a fixed order
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) sq += __shfl_xor_sync(0xffffffffu, sq, off);
  if ((threadIdx.x & 31) == 0) warp_sq[threadIdx.x / 32] = sq;
  __syncthreads();
  if (threadIdx.x == 0) {
    float total = 0.0f;
#pragma unroll
    for (int w = 0; w < kStepThreads / 32; ++w) total += warp_sq[w];
    a.sq[static_cast<long long>(b) * a.H * a.splits + blockIdx.x] = total;
  }
}

template <typename T>
__global__ void __launch_bounds__(kNormThreads) mamba_gated_norm_kernel(const StepArgs a) {
  __shared__ float warp_sum[kNormThreads / 32];
  __shared__ float inv_rms;
  const int chunk = blockIdx.x, g = blockIdx.y, b = blockIdx.z;
  const int per_group = a.d_inner / a.G;
  const int parts = a.heads_per_group * a.splits;  // a group's slices, in head order
  const float* part = a.sq + static_cast<long long>(b) * a.H * a.splits + g * parts;
  float s = 0.0f;
  for (int j = threadIdx.x; j < parts; j += kNormThreads) s += part[j];
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
  if ((threadIdx.x & 31) == 0) warp_sum[threadIdx.x / 32] = s;
  __syncthreads();
  if (threadIdx.x == 0) {
    float total = 0.0f;
#pragma unroll
    for (int w = 0; w < kNormThreads / 32; ++w) total += warp_sum[w];
    const float var = __fmul_rn(total, __fdiv_rn(1.0f, static_cast<float>(per_group)));
    inv_rms = rsqrtf(__fadd_rn(var, a.eps));
  }
  __syncthreads();
  const int c = chunk * kNormThreads + threadIdx.x;
  if (c < per_group) {
    const long long ch = static_cast<long long>(b) * a.d_inner + g * per_group + c;
    const float v = __fmul_rn(__fmul_rn(a.y[ch], inv_rms),
                              to_f32(static_cast<const T*>(a.scale)[g * per_group + c]));
    static_cast<T*>(a.out)[ch] = from_f32<T>(v);
  }
  // the group's B and C conv channels: roll their state by one input
  if (chunk == 0 && threadIdx.x < 2 * a.n) {
    const int half = threadIdx.x / a.n, i = threadIdx.x % a.n;
    const int c = a.d_inner + half * a.G * a.n + g * a.n + i;
    T* cstate = static_cast<T*>(a.conv_state) + b * a.cs_sb;
#pragma unroll
    for (int j = 0; j < kWidth - 2; ++j) cstate[j * a.cs_sw + c] = cstate[(j + 1) * a.cs_sw + c];
    cstate[(kWidth - 2) * a.cs_sw + c] = (static_cast<const T*>(a.zx) + b * a.zx_sb)[a.d_inner + c];
  }
}

template <typename T, int P, int N>
int launch(const StepArgs& a, int batch, cudaStream_t stream) {
  mamba_step_kernel<T, P, N>
      <<<dim3(a.H * a.splits, batch), kStepThreads, 0, stream>>>(a);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int per_group = a.d_inner / a.G;
  mamba_gated_norm_kernel<T>
      <<<dim3((per_group + kNormThreads - 1) / kNormThreads, a.G, batch), kNormThreads, 0,
          stream>>>(a);
  return 0;
}

// P and N as the models have them: 64 (Zamba2-1.2B and -7B), 16 (the
// reduced test configs)
template <typename T, int P>
int dispatch_n(int N, const StepArgs& a, int batch, cudaStream_t stream) {
  switch (N) {
    case 16: return launch<T, P, 16>(a, batch, stream);
    case 64: return launch<T, P, 64>(a, batch, stream);
    default: return -2;
  }
}

template <typename T>
int dispatch(int P, int N, const StepArgs& a, int batch, cudaStream_t stream) {
  switch (P) {
    case 16: return dispatch_n<T, 16>(N, a, batch, stream);
    case 64: return dispatch_n<T, 64>(N, a, batch, stream);
    default: return -2;
  }
}

}  // namespace

extern "C" {

// Returns 0 on success, a negative code for arguments the kernels do not
// take (-1 bad sizes, groups, splits or a conv width other than 4, -2 P or
// N, -3 dtype),
// else the cudaError_t of a launch. Strides, in elements: zx (row), the
// conv weight (tap), the conv state (row, tap); h, the scratch and out are
// contiguous. splits (blocks a head's P rows are cut into) must divide P;
// the launcher (mamba2_step.py::splits) picks it from the shapes.
int mamba2_step_fwd(const void* zx, const void* conv_w, const void* conv_b,
                    const void* dt_bias, const void* a_log, const void* d_skip,
                    const void* scale, void* h, void* conv_state, void* y, void* sq,
                    void* out, int dtype, int B, int H, int P, int N, int G, int W,
                    int splits, double eps, long long zx_sb, long long cw_sw,
                    long long cs_sb, long long cs_sw, int device, void* stream) {
  if (B <= 0 || H <= 0 || G <= 0 || H % G != 0 || W != kWidth) return -1;
  if (splits <= 0 || P % splits != 0 || B > 65535) return -1;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const StepArgs args{zx, conv_w, conv_b, static_cast<const float*>(dt_bias),
                      static_cast<const float*>(a_log), static_cast<const float*>(d_skip),
                      scale, static_cast<float*>(h), conv_state, static_cast<float*>(y),
                      static_cast<float*>(sq), out, H, G, splits, H / G, H * P, N,
                      static_cast<float>(eps), zx_sb, cw_sw, cs_sb, cs_sw};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  int rc;
  if (dtype == 0) {
    rc = dispatch<float>(P, N, args, B, s);
  } else if (dtype == 1) {
    rc = dispatch<__nv_bfloat16>(P, N, args, B, s);
  } else {
    return -3;
  }
  if (rc != 0) return rc;
  return static_cast<int>(cudaGetLastError());
}

const char* mamba2_step_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
