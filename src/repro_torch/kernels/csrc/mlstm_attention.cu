// Parallel mLSTM (xLSTM's prefill) for Hopper, sm_90a. Plain C interface,
// loaded with ctypes by repro_torch/kernels/mlstm_attention.py.
//
// Replaces the TPU kernel src/repro/kernels/mlstm_attention.py::
// mlstm_attention_bhsd (_mlstm_kernel). For each (batch, head) and query i,
// with F the cumulative sum of the log-sigmoid forget gate:
//
//   b_ij = F_i - F_j + log i_j          (j <= i)
//   m_i  = max_j b_ij
//   w_ij = (q_i . k_j / sqrt(D)) * exp(b_ij - m_i)
//   y_i  = sum_j w_ij v_j / max(|sum_j w_ij|, exp(-m_i))
//
// Masked entries (j > i) are 0, not exp(-1e30 - m). F comes from the
// wrapper (torch.cumsum), as the TPU wrapper computes it outside its kernel.
//
// Layout: q/k/v/o (B, S, H, D) and the gates F, log i (B, S, H) f32, each
// addressed through its own element strides (q/k/v/o need a contiguous
// last dim), so the model's head-wise projections and its gate split go in
// without a transpose, pad or copy.
//
// Bound on the H100 (3.35 TB/s, 989 TFLOP/s bf16): at xLSTM-1.3B's serving
// shape B=32, S=128, H=4, D=1024, bf16, the call moves ~134 MB (q, k, v
// and o, 33.5 MB each), ~0.040 ms, against ~4.3 GFLOP of causal work
// (two S x S x D products), ~0.004 ms: bytes bound.
//
// Design (simple first version; mma / wgmma / TMA are later work):
// * The stabiliser m_i depends on the gates alone: it is the prefix maximum
//   of log i_j - F_j, plus F_i. So a block computes it exactly before it
//   touches k and v, and no running-max rescale of the (signed) numerator
//   and denominator is needed, unlike the TPU kernel's online update.
// * D = 1024 is the hard case: a (64, D) f32 accumulator, the TPU kernel's
//   (block_q, D) VMEM scratch, is 256 KB, more than the 227 KB a block may
//   use. Query tiles are therefore 16 rows: the 16 x D f32 accumulator
//   (64 KB) lives in registers, 64 a thread over 256 threads, and the
//   16 x D f32 q tile (64 KB) in dynamic shared memory. Splitting the
//   output's D across blocks instead would recompute each 1024-long q . k
//   product once per slice.
// * One block of 256 threads per (16-row query tile, batch * head). Per key
//   tile of 32 keys: each warp takes keys in turn, holds the key row in
//   registers (D / 32 values a lane), and forms its dot products with the
//   16 q rows (lane-strided, conflict-free shared reads, five
//   xor-shuffles); lane 0 writes the weight w_ij into a 16 x 32 shared
//   tile. Then every thread adds w_ij v_j into its rows and columns of the
//   accumulator and w_ij into its rows' denominators. Key tiles past the
//   query tile's last row are never visited (causal skip).
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;
constexpr int kBlockQ = 16;
constexpr int kBlockK = 32;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
mlstm_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, const float* __restrict__ fcum,
                 const float* __restrict__ logi, T* __restrict__ o, int S, int H,
                 int64_t q_sb, int64_t q_ss, int64_t q_sh,
                 int64_t k_sb, int64_t k_ss, int64_t k_sh,
                 int64_t v_sb, int64_t v_ss, int64_t v_sh,
                 int64_t f_sb, int64_t f_ss, int64_t f_sh,
                 int64_t l_sb, int64_t l_ss, int64_t l_sh,
                 int64_t o_sb, int64_t o_ss, int64_t o_sh, float sqrt_d) {
  constexpr int DW = D / 32;                          // key values a lane holds
  constexpr int TC = D < kThreads ? D : kThreads;     // threads across columns
  constexpr int RG = kThreads / TC;                   // row groups
  constexpr int RPT = kBlockQ / RG;                   // accumulator rows a thread
  constexpr int CPT = D / TC;                         // accumulator columns a thread
  static_assert(D % 32 == 0 && RG * TC == kThreads && RPT * RG == kBlockQ &&
                CPT * TC == D, "tiling");

  extern __shared__ float qs[];                       // [kBlockQ][D], q / sqrt(D)
  __shared__ float ws[kBlockQ][kBlockK];              // this key tile's w_ij
  __shared__ float fq[kBlockQ];                       // F_i
  __shared__ float mq[kBlockQ];                       // m_i

  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh - b * H;
  const int q0 = blockIdx.x * kBlockQ;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;

  const T* qb = q + b * q_sb + h * q_sh;
  const T* kb = k + b * k_sb + h * k_sh;
  const T* vb = v + b * v_sb + h * v_sh;
  const float* fb = fcum + b * f_sb + h * f_sh;
  const float* lb = logi + b * l_sb + h * l_sh;

  // 1. the q tile, f32 and scaled; rows past S are zero
  for (int idx = tid; idx < kBlockQ * D; idx += kThreads) {
    const int r = idx / D;
    const int d = idx - r * D;
    const int qp = q0 + r;
    qs[idx] = qp < S ? to_f32(qb[qp * q_ss + d]) / sqrt_d : 0.f;
  }
  // 2. F_i and the exact stabiliser m_i = max_{j <= i} (F_i - F_j) + log i_j
  for (int r = warp; r < kBlockQ; r += kWarps) {
    const int qp = q0 + r;
    float fi = 0.f, mx = 0.f;
    if (qp < S) {  // warp-uniform
      fi = fb[qp * f_ss];
      mx = kNegInf;
      for (int j = lane; j <= qp; j += 32) mx = fmaxf(mx, (fi - fb[j * f_ss]) + lb[j * l_ss]);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
    }
    if (lane == 0) {
      fq[r] = fi;
      mq[r] = mx;
    }
  }
  __syncthreads();

  const int tc = tid % TC;
  const int rg = tid / TC;
  float acc[RPT][CPT];
  float den[RPT];
#pragma unroll
  for (int r = 0; r < RPT; ++r) {
    den[r] = 0.f;
#pragma unroll
    for (int u = 0; u < CPT; ++u) acc[r][u] = 0.f;
  }

  // causal: keys past this query tile's last row are never visited
  const int k_end = min(S, q0 + kBlockQ);
  for (int k0 = 0; k0 < k_end; k0 += kBlockK) {
    const int nk = min(kBlockK, k_end - k0);
    // 3a. weights of the key tile, one key a warp at a time
    for (int jj = warp; jj < nk; jj += kWarps) {
      const int j = k0 + jj;
      float kr[DW];
#pragma unroll
      for (int t = 0; t < DW; ++t) kr[t] = to_f32(kb[j * k_ss + lane + 32 * t]);
      const float fj = fb[j * f_ss];
      const float lj = lb[j * l_ss];
#pragma unroll
      for (int r = 0; r < kBlockQ; ++r) {  // 16 independent FMA and shuffle chains
        float part = 0.f;
#pragma unroll
        for (int t = 0; t < DW; ++t) part = fmaf(qs[r * D + lane + 32 * t], kr[t], part);
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) part += __shfl_xor_sync(0xffffffffu, part, off);
        if (lane == 0) {
          const int qp = q0 + r;
          ws[r][jj] = (qp < S && j <= qp) ? part * expf(((fq[r] - fj) + lj) - mq[r]) : 0.f;
        }
      }
    }
    __syncthreads();
    // 3b. num += w_ij v_j and den += w_ij for this thread's rows and columns
#pragma unroll 4
    for (int jj = 0; jj < nk; ++jj) {  // unrolled so v loads of later keys overlap
      const T* vr = vb + (k0 + jj) * v_ss;
      float vv[CPT];
#pragma unroll
      for (int u = 0; u < CPT; ++u) vv[u] = to_f32(vr[tc + TC * u]);
#pragma unroll
      for (int r = 0; r < RPT; ++r) {
        const float w = ws[rg + RG * r][jj];
        den[r] += w;
#pragma unroll
        for (int u = 0; u < CPT; ++u) acc[r][u] = fmaf(w, vv[u], acc[r][u]);
      }
    }
    __syncthreads();  // ws is rewritten by the next key tile
  }

  // 4. y_i = num_i / max(|den_i|, exp(-m_i))
#pragma unroll
  for (int r = 0; r < RPT; ++r) {
    const int row = rg + RG * r;
    const int qp = q0 + row;
    if (qp < S) {
      const float nrm = fmaxf(fabsf(den[r]), expf(-mq[row]));
      T* ob = o + b * o_sb + qp * o_ss + h * o_sh;
#pragma unroll
      for (int u = 0; u < CPT; ++u) ob[tc + TC * u] = from_f32<T>(acc[r][u] / nrm);
    }
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, const void* f, const void* l,
           void* o, int B, int S, int H, const long long* st, cudaStream_t stream) {
  const int smem = kBlockQ * D * static_cast<int>(sizeof(float));
  cudaError_t err = cudaFuncSetAttribute(mlstm_fwd_kernel<T, D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid((S + kBlockQ - 1) / kBlockQ, B * H);
  mlstm_fwd_kernel<T, D><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const float*>(f), static_cast<const float*>(l), static_cast<T*>(o), S, H,
      st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7], st[8],
      st[9], st[10], st[11], st[12], st[13], st[14], st[15], st[16], st[17],
      sqrtf(static_cast<float>(D)));
  return 0;
}

template <typename T>
int dispatch_d(int D, const void* q, const void* k, const void* v, const void* f,
               const void* l, void* o, int B, int S, int H, const long long* st,
               cudaStream_t stream) {
  switch (D) {
    case 32: return launch<T, 32>(q, k, v, f, l, o, B, S, H, st, stream);
    case 64: return launch<T, 64>(q, k, v, f, l, o, B, S, H, st, stream);
    case 128: return launch<T, 128>(q, k, v, f, l, o, B, S, H, st, stream);
    case 256: return launch<T, 256>(q, k, v, f, l, o, B, S, H, st, stream);
    case 512: return launch<T, 512>(q, k, v, f, l, o, B, S, H, st, stream);
    case 1024: return launch<T, 1024>(q, k, v, f, l, o, B, S, H, st, stream);
    default: return -2;
  }
}

}  // namespace

extern "C" {

// Returns 0 on success, a negative code for arguments the kernel does not
// take (-1 bad sizes, -2 head dim, -3 dtype), else the cudaError_t of the
// launch. Strides, in elements, are (batch, seq, head) for q, k, v, F,
// log i and o, in that order.
int mlstm_attention_fwd(const void* q, const void* k, const void* v, const void* fcum,
                        const void* logi, void* o, int dtype, int B, int S, int H, int D,
                        long long q_sb, long long q_ss, long long q_sh,
                        long long k_sb, long long k_ss, long long k_sh,
                        long long v_sb, long long v_ss, long long v_sh,
                        long long f_sb, long long f_ss, long long f_sh,
                        long long l_sb, long long l_ss, long long l_sh,
                        long long o_sb, long long o_ss, long long o_sh,
                        int device, void* stream) {
  if (B <= 0 || S <= 0 || H <= 0 || static_cast<long long>(B) * H > 65535) return -1;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long st[18] = {q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh,
                            f_sb, f_ss, f_sh, l_sb, l_ss, l_sh, o_sb, o_ss, o_sh};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int rc;
  if (dtype == 0) {
    rc = dispatch_d<float>(D, q, k, v, fcum, logi, o, B, S, H, st, s);
  } else if (dtype == 1) {
    rc = dispatch_d<__nv_bfloat16>(D, q, k, v, fcum, logi, o, B, S, H, st, s);
  } else {
    return -3;
  }
  if (rc != 0) return rc;
  return static_cast<int>(cudaGetLastError());
}

const char* mlstm_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
