// Mamba-2 SSD chunked scan (Zamba2's prefill) for Hopper, sm_90a. Plain C
// interface, loaded with ctypes by repro_torch/kernels/ssd_scan.py.
//
// Replaces the TPU kernel src/repro/kernels/ssd_scan.py::ssd_scan_bhsd
// (_ssd_kernel). For each (batch, head), with da = dt * a, its cumulative
// sum cum within a chunk and the (P x N) f32 state h carried from chunk to
// chunk (zero before the first):
//
//   y[q]  = sum_{k <= q} (C[q] . B[k]) exp(cum[q] - cum[k]) dt[k] x[k]
//         + exp(cum[q]) C[q] h^T                          (h entering the chunk)
//   h     = h exp(cum[Q-1]) + sum_k x[k] (B[k] exp(cum[Q-1] - cum[k]) dt[k])
//
// As the TPU kernel, it takes no initial state and returns no final state
// (the model folds the prompt into its decode state beside the kernel), and
// it computes everything in f32; y is stored in x's dtype.
//
// Layout: x and y (B, S, H, P), dt (B, S, H) f32, a (H,) f32, B and C
// (B, S, N) shared by every head of a batch row (ngroups = 1), each through
// its own element strides (x, B and C need a contiguous last dim). So the
// model's views of its conv output go in without a transpose, pad or copy
// per head. The ragged last chunk is handled here: rows past S read dt = 0,
// x = B = C = 0 (exact: no decay, no injection) and are not stored.
//
// Bound on the H100 (3.35 TB/s, 989 TFLOP/s bf16): at Zamba2-1.2B's serving
// shape B=32, S=128, H=64, P=N=64, bf16, the call moves ~69 MB (x and y,
// 33.6 MB each; dt 1 MB; B and C 1 MB), ~0.021 ms, against ~13 GFLOP of
// chunk products, ~0.013 ms: bytes bound.
//
// Design (simple first version; tensor cores, a CB^T shared by the heads of
// a batch row and an emitted final state are later work):
// * One block of 256 threads per (batch, head) walks the chunks in order,
//   the TPU kernel's sequential grid axis as a loop; the f32 state stays in
//   shared memory throughout.
// * Per chunk it stages x (Q x P), B (Q x N), dt and the cumulative da in
//   shared memory as f32 (one warp scans da), then takes the Q query rows
//   in blocks of 32: the block's C rows, its 32 x Q masked weight tile
//   (C . B, the decay and dt; keys past the block's last row are never
//   visited), then y for those rows from the tile and from the carried
//   state. After the last row block the state is updated.
// * Each product is register-tiled (a thread owns a small rows x cols tile
//   and reads each operand once per reduction step); rows of B, C and h
//   are padded to N + 1 floats, so the lanes of a warp that read different
//   rows at the same column hit different banks.
// * Shared memory at P = N = 64, Q = 128: ~108 KB (two blocks an SM); at
//   P = N = 128 it is ~227 KB, just within what a block may use.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxChunk = 128;
constexpr int kRowBlock = 32;  // query rows per weight tile

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// A (ROWS x COLS) tile spread over the block's 256 threads: TC threads
// across the columns (consecutive lanes on consecutive columns), TR across
// the rows; a thread owns rows tr + TR * i and columns tc + TC * j.
template <int ROWS, int COLS>
struct Tile {
  static constexpr int TC = COLS < 32 ? COLS : 32;
  static constexpr int TR = kThreads / TC;
  static constexpr int RPT = (ROWS + TR - 1) / TR;
  static constexpr int CPT = COLS / TC;
  static_assert(COLS % TC == 0 && kThreads % TC == 0, "tile");
};

__host__ __device__ constexpr int smem_floats(int P, int N, int Q) {
  return P * (N + 1)            // h
         + Q * P                // x
         + Q * (N + 1)          // B
         + kRowBlock * (N + 1)  // C rows of one row block
         + kRowBlock * Q        // weights of one row block
         + 3 * Q;               // dt, cum, dt * decay to the chunk end
}

template <typename T, int P, int N>
__global__ void __launch_bounds__(kThreads)
ssd_scan_kernel(const T* __restrict__ x, const float* __restrict__ dt,
                const float* __restrict__ a, const T* __restrict__ bm,
                const T* __restrict__ cm, T* __restrict__ y, int S, int H, int Q,
                int64_t x_sb, int64_t x_ss, int64_t x_sh,
                int64_t d_sb, int64_t d_ss, int64_t d_sh,
                int64_t b_sb, int64_t b_ss, int64_t c_sb, int64_t c_ss,
                int64_t y_sb, int64_t y_ss, int64_t y_sh) {
  constexpr int NP = N + 1;  // padded row of h, B and C
  extern __shared__ float smem[];
  float* hs = smem;                    // [P][NP]
  float* xs = hs + P * NP;             // [Q][P]
  float* bs = xs + Q * P;              // [Q][NP]
  float* cs = bs + Q * NP;             // [kRowBlock][NP]
  float* ws = cs + kRowBlock * NP;     // [kRowBlock][Q]
  float* dts = ws + kRowBlock * Q;     // [Q]
  float* cum = dts + Q;                // [Q]
  float* sc = cum + Q;                 // [Q]

  const int bh = blockIdx.x;
  const int b = bh / H;
  const int h = bh - b * H;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const float ah = a[h];

  const T* xb = x + b * x_sb + h * x_sh;
  const float* db = dt + b * d_sb + h * d_sh;
  const T* bb = bm + b * b_sb;
  const T* cb = cm + b * c_sb;
  T* yb = y + b * y_sb + h * y_sh;

  for (int i = tid; i < P * NP; i += kThreads) hs[i] = 0.f;

  for (int c0 = 0; c0 < S; c0 += Q) {
    const int L = min(Q, S - c0);  // valid rows of this chunk
    __syncthreads();  // the previous chunk's state update is done with x, B, sc
    // 1. stage x, B and dt; rows past S are zero
    for (int i = tid; i < Q * P; i += kThreads) {
      const int r = i / P;
      const int p = i - r * P;
      xs[i] = r < L ? to_f32(xb[(c0 + r) * x_ss + p]) : 0.f;
    }
    for (int i = tid; i < Q * N; i += kThreads) {
      const int r = i / N;
      const int n = i - r * N;
      bs[r * NP + n] = r < L ? to_f32(bb[(c0 + r) * b_ss + n]) : 0.f;
    }
    for (int r = tid; r < Q; r += kThreads) dts[r] = r < L ? db[(c0 + r) * d_ss] : 0.f;
    __syncthreads();
    // 2. cum = inclusive prefix sum of dt * a, one warp, kMaxChunk / 32 rows a lane
    if (warp == 0) {
      constexpr int E = kMaxChunk / 32;
      float v[E];
      float run = 0.f;
#pragma unroll
      for (int e = 0; e < E; ++e) {
        const int r = lane * E + e;
        run += r < Q ? dts[r] * ah : 0.f;
        v[e] = run;
      }
      float incl = run;  // inclusive scan of the lanes' totals
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const float t = __shfl_up_sync(0xffffffffu, incl, off);
        if (lane >= off) incl += t;
      }
      float before = __shfl_up_sync(0xffffffffu, incl, 1);  // the lanes before
      if (lane == 0) before = 0.f;
#pragma unroll
      for (int e = 0; e < E; ++e) {
        const int r = lane * E + e;
        if (r < Q) cum[r] = before + v[e];
      }
    }
    __syncthreads();
    const float total = cum[Q - 1];
    for (int r = tid; r < Q; r += kThreads) sc[r] = expf(total - cum[r]) * dts[r];

    // 3. the query rows, kRowBlock at a time
    for (int r0 = 0; r0 < L; r0 += kRowBlock) {
      const int rows = min(kRowBlock, L - r0);
      const int kend = min(L, r0 + rows);  // keys past the last row are masked
      for (int i = tid; i < kRowBlock * N; i += kThreads) {
        const int r = i / N;
        const int n = i - r * N;
        cs[r * NP + n] = r < rows ? to_f32(cb[(c0 + r0 + r) * c_ss + n]) : 0.f;
      }
      __syncthreads();
      // 3a. ws[r][k] = (C[r0+r] . B[k]) exp(cum[r0+r] - cum[k]) dt[k] for k <= r0+r
      {
        using W = Tile<kRowBlock, kMaxChunk>;
        const int tc = tid % W::TC;
        const int tr = tid / W::TC;
        float acc[W::RPT][W::CPT];
#pragma unroll
        for (int i = 0; i < W::RPT; ++i)
#pragma unroll
          for (int j = 0; j < W::CPT; ++j) acc[i][j] = 0.f;
        int kk[W::CPT];
#pragma unroll
        for (int j = 0; j < W::CPT; ++j) kk[j] = min(tc + W::TC * j, Q - 1);
#pragma unroll 4
        for (int n = 0; n < N; ++n) {
          float cv[W::RPT], bv[W::CPT];
#pragma unroll
          for (int i = 0; i < W::RPT; ++i) cv[i] = cs[(tr + W::TR * i) * NP + n];
#pragma unroll
          for (int j = 0; j < W::CPT; ++j) bv[j] = bs[kk[j] * NP + n];
#pragma unroll
          for (int i = 0; i < W::RPT; ++i)
#pragma unroll
            for (int j = 0; j < W::CPT; ++j) acc[i][j] = fmaf(cv[i], bv[j], acc[i][j]);
        }
#pragma unroll
        for (int i = 0; i < W::RPT; ++i) {
          const int r = tr + W::TR * i;
          const int q = r0 + r;
#pragma unroll
          for (int j = 0; j < W::CPT; ++j) {
            const int k = tc + W::TC * j;
            if (k < kend) {
              ws[r * Q + k] = (r < rows && k <= q)
                                  ? acc[i][j] * expf(cum[q] - cum[k]) * dts[k] : 0.f;
            }
          }
        }
      }
      __syncthreads();
      // 3b. y[r0+r][p] = sum_k ws[r][k] x[k][p] + exp(cum[r0+r]) sum_n C[r0+r][n] h[p][n]
      {
        using Y = Tile<kRowBlock, P>;
        const int tc = tid % Y::TC;
        const int tr = tid / Y::TC;
        float acc[Y::RPT][Y::CPT];
        float off[Y::RPT][Y::CPT];
        int rr[Y::RPT];
#pragma unroll
        for (int i = 0; i < Y::RPT; ++i) {
          rr[i] = min(tr + Y::TR * i, kRowBlock - 1);
#pragma unroll
          for (int j = 0; j < Y::CPT; ++j) acc[i][j] = off[i][j] = 0.f;
        }
        for (int k = 0; k < kend; ++k) {
          float wv[Y::RPT], xv[Y::CPT];
#pragma unroll
          for (int i = 0; i < Y::RPT; ++i) wv[i] = ws[rr[i] * Q + k];
#pragma unroll
          for (int j = 0; j < Y::CPT; ++j) xv[j] = xs[k * P + tc + Y::TC * j];
#pragma unroll
          for (int i = 0; i < Y::RPT; ++i)
#pragma unroll
            for (int j = 0; j < Y::CPT; ++j) acc[i][j] = fmaf(wv[i], xv[j], acc[i][j]);
        }
#pragma unroll 4
        for (int n = 0; n < N; ++n) {
          float cv[Y::RPT], hv[Y::CPT];
#pragma unroll
          for (int i = 0; i < Y::RPT; ++i) cv[i] = cs[rr[i] * NP + n];
#pragma unroll
          for (int j = 0; j < Y::CPT; ++j) hv[j] = hs[(tc + Y::TC * j) * NP + n];
#pragma unroll
          for (int i = 0; i < Y::RPT; ++i)
#pragma unroll
            for (int j = 0; j < Y::CPT; ++j) off[i][j] = fmaf(cv[i], hv[j], off[i][j]);
        }
#pragma unroll
        for (int i = 0; i < Y::RPT; ++i) {
          const int r = tr + Y::TR * i;
          if (r < rows) {
            const int q = r0 + r;
            const float decay = expf(cum[q]);
            T* yr = yb + (c0 + q) * y_ss;
#pragma unroll
            for (int j = 0; j < Y::CPT; ++j) {
              yr[tc + Y::TC * j] = from_f32<T>(acc[i][j] + decay * off[i][j]);
            }
          }
        }
      }
      __syncthreads();  // cs and ws are rewritten by the next row block
    }

    // 4. h = h exp(total) + sum_k (x[k] sc[k]) (x) B[k]
    {
      using U = Tile<P, N>;
      const int tc = tid % U::TC;
      const int tr = tid / U::TC;
      float acc[U::RPT][U::CPT];
      int pp[U::RPT];
#pragma unroll
      for (int i = 0; i < U::RPT; ++i) {
        pp[i] = min(tr + U::TR * i, P - 1);
#pragma unroll
        for (int j = 0; j < U::CPT; ++j) acc[i][j] = 0.f;
      }
      for (int k = 0; k < L; ++k) {
        const float s = sc[k];
        float xv[U::RPT], bv[U::CPT];
#pragma unroll
        for (int i = 0; i < U::RPT; ++i) xv[i] = xs[k * P + pp[i]] * s;
#pragma unroll
        for (int j = 0; j < U::CPT; ++j) bv[j] = bs[k * NP + tc + U::TC * j];
#pragma unroll
        for (int i = 0; i < U::RPT; ++i)
#pragma unroll
          for (int j = 0; j < U::CPT; ++j) acc[i][j] = fmaf(xv[i], bv[j], acc[i][j]);
      }
      const float keep = expf(total);
#pragma unroll
      for (int i = 0; i < U::RPT; ++i) {
        const int p = tr + U::TR * i;
        if (p < P) {
#pragma unroll
          for (int j = 0; j < U::CPT; ++j) {
            float* hp = hs + p * NP + tc + U::TC * j;
            *hp = *hp * keep + acc[i][j];
          }
        }
      }
    }
  }
}

template <typename T, int P, int N>
int launch(const void* x, const void* dt, const void* a, const void* bm, const void* cm,
           void* y, int B, int S, int H, int Q, const long long* st, cudaStream_t stream) {
  const int smem = smem_floats(P, N, Q) * static_cast<int>(sizeof(float));
  cudaError_t err = cudaFuncSetAttribute(ssd_scan_kernel<T, P, N>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  ssd_scan_kernel<T, P, N><<<B * H, kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(dt), static_cast<const float*>(a),
      static_cast<const T*>(bm), static_cast<const T*>(cm), static_cast<T*>(y), S, H, Q,
      st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7], st[8], st[9],
      st[10], st[11], st[12]);
  return 0;
}

template <typename T, int P>
int dispatch_n(int N, const void* x, const void* dt, const void* a, const void* bm,
               const void* cm, void* y, int B, int S, int H, int Q, const long long* st,
               cudaStream_t s) {
  switch (N) {
    case 8: return launch<T, P, 8>(x, dt, a, bm, cm, y, B, S, H, Q, st, s);
    case 16: return launch<T, P, 16>(x, dt, a, bm, cm, y, B, S, H, Q, st, s);
    case 32: return launch<T, P, 32>(x, dt, a, bm, cm, y, B, S, H, Q, st, s);
    case 64: return launch<T, P, 64>(x, dt, a, bm, cm, y, B, S, H, Q, st, s);
    case 128: return launch<T, P, 128>(x, dt, a, bm, cm, y, B, S, H, Q, st, s);
    default: return -2;
  }
}

template <typename T>
int dispatch_p(int P, int N, const void* x, const void* dt, const void* a, const void* bm,
               const void* cm, void* y, int B, int S, int H, int Q, const long long* st,
               cudaStream_t s) {
  switch (P) {
    case 8: return dispatch_n<T, 8>(N, x, dt, a, bm, cm, y, B, S, H, Q, st, s);
    case 16: return dispatch_n<T, 16>(N, x, dt, a, bm, cm, y, B, S, H, Q, st, s);
    case 32: return dispatch_n<T, 32>(N, x, dt, a, bm, cm, y, B, S, H, Q, st, s);
    case 64: return dispatch_n<T, 64>(N, x, dt, a, bm, cm, y, B, S, H, Q, st, s);
    case 128: return dispatch_n<T, 128>(N, x, dt, a, bm, cm, y, B, S, H, Q, st, s);
    default: return -2;
  }
}

}  // namespace

extern "C" {

// Returns 0 on success, a negative code for arguments the kernel does not
// take (-1 bad sizes or chunk, -2 P or N, -3 dtype), else the cudaError_t
// of the launch. Strides, in elements: x (batch, seq, head), dt (batch,
// seq, head), B (batch, seq), C (batch, seq), y (batch, seq, head).
int ssd_scan_fwd(const void* x, const void* dt, const void* a, const void* bm,
                 const void* cm, void* y, int dtype, int B, int S, int H, int P, int N,
                 int chunk, long long x_sb, long long x_ss, long long x_sh,
                 long long d_sb, long long d_ss, long long d_sh,
                 long long b_sb, long long b_ss, long long c_sb, long long c_ss,
                 long long y_sb, long long y_ss, long long y_sh, int device, void* stream) {
  if (B <= 0 || S <= 0 || H <= 0 || chunk <= 0 || chunk > kMaxChunk) return -1;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long st[13] = {x_sb, x_ss, x_sh, d_sb, d_ss, d_sh,
                            b_sb, b_ss, c_sb, c_ss, y_sb, y_ss, y_sh};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int rc;
  if (dtype == 0) {
    rc = dispatch_p<float>(P, N, x, dt, a, bm, cm, y, B, S, H, chunk, st, s);
  } else if (dtype == 1) {
    rc = dispatch_p<__nv_bfloat16>(P, N, x, dt, a, bm, cm, y, B, S, H, chunk, st, s);
  } else {
    return -3;
  }
  if (rc != 0) return rc;
  return static_cast<int>(cudaGetLastError());
}

const char* ssd_scan_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
