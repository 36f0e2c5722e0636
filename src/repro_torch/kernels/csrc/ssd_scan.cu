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
// (the model folds the prompt into its decode state beside the kernel).
// y is stored in x's dtype.
//
// Layout: x and y (B, S, H, P), dt (B, S, H) f32, a (H,) f32, B and C
// (B, S, NG, N) with NG groups of H / NG heads (head h reads group
// h / (H / NG); NG = 1, a group stride of 0, is B and C shared by every
// head, as Zamba2-1.2B's; Zamba2-7B has two groups of 56), each through its
// own element strides (x, B and C need a contiguous last dim). So the
// model's views of its conv output go in without a transpose, pad or copy
// per head. The ragged last chunk is handled here: rows past S read dt = 0,
// x = B = C = 0 (exact: no decay, no injection) and are not stored.
//
// Bound on the H100 (3.35 TB/s, 989 TFLOP/s bf16): at Zamba2-1.2B's serving
// shape B=32, S=128, H=64, P=N=64, bf16, the call moves ~69 MB (x and y,
// 33.6 MB each; dt 1 MB; B and C 1 MB), ~0.021 ms, against ~13 GFLOP of
// chunk products, ~0.013 ms: bytes bound.
//
// Carried state only where it is read (both dtypes; exact): the first
// chunk skips C h^T (h = 0 there) and the last chunk skips the state
// update (nothing reads it). A prompt of at most one chunk, as every
// serving prefill (buckets 32 and 128, chunk 128), runs neither.
//
// bf16 with P and N in {16, 32, 64, 128} (every serving run): a tensor-core
// kernel on mma.sync.m16n8k16 (bf16 in, f32 accumulate).
// * One block per (batch row, run of G heads) walks the chunks; G comes
//   from the launcher (ssd_scan.py::heads_per_block): the most of 8, 4, 2
//   and 1 that still gives every SM a block, divides the heads of a B/C
//   group (so a block's heads read one B and one C), and whose f32 states
//   fit in shared memory (each head's (P x N) state, 16 KB at P = N = 64, lives
//   there from chunk to chunk, and only when there is more than one
//   chunk). At the serving shape G = 8: 256 blocks of 102 KB, two an SM,
//   one wave (the previous design ran 2,048 blocks, ~7.8 waves).
// * One warp per 16-row query tile of the chunk (ceil(Q / 16) warps, 8 at
//   Q = 128). Per chunk the block stages B and C (Q x N, bf16) once with
//   16-byte cp.async into padded tiles, and each warp computes its rows of
//   C B^T once for the whole group with mma.sync, key tiles at or below its
//   last row only (the previous design formed C B^T in each of the 64 heads'
//   blocks, all 128 key columns of every row block). The C B^T fragments
//   stay in registers for all G heads.
// * Per head: one warp per head scans dt * a (in log2 units) into cum; each
//   warp builds w = C B^T * exp2(cum_q - cum_k) * dt_k in registers from its
//   fragments (the exponent of the difference, never exp(-cum_k) alone,
//   which overflows at Zamba2's decay rates; by ex2.approx.ftz, 9% faster
//   than exp2f at the serving shape), splits it into bf16 hi =
//   bf16(w) and lo = bf16(w - hi) and runs y = w_hi x + w_lo x on the tensor
//   cores, x (Q x P) through ldmatrix.trans. The split keeps w to ~2^-16
//   of itself, near f32 (a single bf16 rounding of w misses the f32 gate).
//   x tiles are double-buffered: head g+1's x loads while head g computes.
//   y is staged in shared memory and written with 16-byte stores.
// * Multi-chunk inputs (tests, longer prompts): C h^T on the tensor cores
//   with h split hi + lo the same way, and the state update as
//   x^T (B * exp2(total - cum) * dt) with the f32 right factor split hi + lo;
//   h stays f32 in shared memory.
// * Warps w and w + 4 share an SM sub-partition; their row tiles sum to 7
//   at 8 warps, which evens out the causal work between sub-partitions.
// What it does about the previous design's four costs: (1) C B^T once per
// group and causal tiles only; (2) tensor cores for every product; (3) the
// dead state terms skipped; (4) one wave at the serving shape.
//
// float32 (tests and the reduced models; no serving run), and bf16 at P or
// N = 8: the first version's CUDA-core kernel, exact f32, with the two
// state skips above. One block of 256 threads per (batch, head) walks the
// chunks with the f32 state in shared memory; per chunk it stages x, B, dt
// and the cumulative da as f32 and takes the query rows in blocks of 32
// (masked weight tile, then y), register-tiled, rows of B, C and h padded
// to N + 1 floats.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "tensor_core.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxChunk = 128;
constexpr int kRowBlock = 32;  // query rows per weight tile
constexpr int kMaxSmem = 232448;  // dynamic shared memory a block may use
constexpr float kLog2e = 1.4426950408889634f;

// ------------------------------------------------------ CUDA-core kernel
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
                const T* __restrict__ cm, T* __restrict__ y, int S, int H, int Q, int hpg,
                int64_t x_sb, int64_t x_ss, int64_t x_sh,
                int64_t d_sb, int64_t d_ss, int64_t d_sh,
                int64_t b_sb, int64_t b_ss, int64_t b_sg, int64_t c_sb, int64_t c_ss,
                int64_t c_sg, int64_t y_sb, int64_t y_ss, int64_t y_sh) {
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
  const T* bb = bm + b * b_sb + (h / hpg) * b_sg;
  const T* cb = cm + b * c_sb + (h / hpg) * c_sg;
  T* yb = y + b * y_sb + h * y_sh;

  for (int c0 = 0; c0 < S; c0 += Q) {
    const int L = min(Q, S - c0);  // valid rows of this chunk
    const bool first = c0 == 0;    // h = 0 entering it: no C h^T
    const bool last = c0 + Q >= S;  // nothing reads the state after it
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
        if (!first) {  // block-uniform
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

    // 4. h = h exp(total) + sum_k (x[k] sc[k]) (x) B[k]; the first chunk
    // writes h without reading it, the last one skips it
    if (!last) {
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
            *hp = first ? acc[i][j] : *hp * keep + acc[i][j];
          }
        }
      }
    }
  }
}

// --------------------------------------------------- bf16, tensor cores
constexpr int kMmaMaxWarps = kMaxChunk / 16;  // one 16-row query tile a warp
constexpr int kMaxHeadsPerBlock = 8;

// Byte offsets of the tensor-core kernel's shared memory; QR = the chunk's
// rows rounded up to 16, G heads, nbuf x buffers, f32 states if carried.
// ssd_scan.py::mma_smem_bytes mirrors the total.
struct MmaSmem {
  int bs, cs, xs, ys, cum, dts, sc, hs, total;
};

__host__ __device__ inline MmaSmem mma_smem(int P, int N, int QR, int G, int nbuf, bool state) {
  MmaSmem m;
  int off = 0;
  m.bs = off;  off += QR * (N + 8) * 2;       // B, bf16, padded rows
  m.cs = off;  off += QR * (N + 8) * 2;       // C
  m.xs = off;  off += nbuf * QR * (P + 8) * 2;  // x of one head, per buffer
  m.ys = off;  off += QR * (P + 8) * 2;       // y staging, 16 rows a warp
  m.cum = off; off += G * QR * 4;             // cum (log2 units), per head
  m.dts = off; off += G * QR * 4;             // dt
  m.sc = off;  off += G * QR * 4;             // exp2(total - cum) dt
  m.hs = off;  off += state ? G * P * (N + 8) * 4 : 0;  // f32 states
  m.total = off;
  return m;
}

template <int P, int N>
__global__ void __launch_bounds__(kMmaMaxWarps * 32, P <= 64 ? 2 : 1)
ssd_mma_kernel(const bf16* __restrict__ x, const float* __restrict__ dt,
               const float* __restrict__ a, const bf16* __restrict__ bm,
               const bf16* __restrict__ cm, bf16* __restrict__ y, int S, int H, int Q,
               int G, int nbuf, int hpg,
               int64_t x_sb, int64_t x_ss, int64_t x_sh,
               int64_t d_sb, int64_t d_ss, int64_t d_sh,
               int64_t b_sb, int64_t b_ss, int64_t b_sg, int64_t c_sb, int64_t c_ss,
               int64_t c_sg, int64_t y_sb, int64_t y_ss, int64_t y_sh) {
  constexpr int LDN = N + 8;  // padded bf16 row of B and C
  constexpr int LDP = P + 8;  // padded bf16 row of x and y
  constexpr int LDH = N + 8;  // padded f32 row of a state
  constexpr int NCH = N / 8;  // 16-byte chunks of a B or C row
  constexpr int PCH = P / 8;  // of an x or y row
  constexpr int PT = P / 8;   // 8-column n-tiles of y
  constexpr int KN = N / 16;  // k-steps over N
  constexpr int MAXT = 2 * kMmaMaxWarps;  // 8-key n-tiles of C B^T
  const int nwarps = blockDim.x / 32;
  const int QR = nwarps * 16;
  const bool carry = S > Q;
  const MmaSmem lay = mma_smem(P, N, QR, G, nbuf, carry);
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* bs = reinterpret_cast<bf16*>(smem_raw + lay.bs);   // [QR][LDN]
  bf16* cs = reinterpret_cast<bf16*>(smem_raw + lay.cs);   // [QR][LDN]
  bf16* xs = reinterpret_cast<bf16*>(smem_raw + lay.xs);   // [nbuf][QR][LDP]
  bf16* ys = reinterpret_cast<bf16*>(smem_raw + lay.ys);   // [QR][LDP]
  float* cum = reinterpret_cast<float*>(smem_raw + lay.cum);  // [G][QR]
  float* dts = reinterpret_cast<float*>(smem_raw + lay.dts);  // [G][QR]
  float* scs = reinterpret_cast<float*>(smem_raw + lay.sc);   // [G][QR]
  float* hs = reinterpret_cast<float*>(smem_raw + lay.hs);    // [G][P][LDH]

  const int n_groups = (H + G - 1) / G;
  const int b = blockIdx.x / n_groups;
  const int h0 = (blockIdx.x - b * n_groups) * G;
  const int nh = min(G, H - h0);
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  // this warp's 16-row query tile; warps w and w + 4 share a sub-partition
  const int rt = (warp < 4 || nwarps <= 4) ? warp : nwarps + 3 - warp;
  const int q0 = rt * 16;
  const int r_lo = q0 + lane / 4;  // fragment rows r_lo and r_lo + 8

  const bf16* xb = x + b * x_sb + h0 * x_sh;
  const float* db = dt + b * d_sb + h0 * d_sh;
  // the launcher keeps G a divisor of hpg: every head of the block is in h0's group
  const bf16* bb = bm + b * b_sb + (h0 / hpg) * b_sg;
  const bf16* cb = cm + b * c_sb + (h0 / hpg) * c_sg;
  bf16* yb = y + b * y_sb + h0 * y_sh;

  // rows [0, QR) of a chunk tile, zeros from row L on
  auto load_rows = [&](bf16* dst, int ld, const bf16* src, int64_t rs, int nch, int L) {
    for (int idx = tid; idx < QR * nch; idx += blockDim.x) {
      const int r = idx / nch;
      const int c = idx - r * nch;
      const bool ok = r < L;
      cp_async16(dst + r * ld + c * 8, src + (ok ? r : 0) * rs + c * 8, ok);
    }
  };

  for (int c0 = 0; c0 < S; c0 += Q) {
    const int L = min(Q, S - c0);  // valid rows of this chunk
    const bool first = c0 == 0;     // h = 0 entering it: no C h^T
    const bool last = c0 + Q >= S;  // nothing reads the state after it
    const bool active = q0 < L;     // warp-uniform: this warp's rows hold data
    __syncthreads();  // the previous chunk is done with every tile
    load_rows(bs, LDN, bb + c0 * b_ss, b_ss, NCH, L);
    load_rows(cs, LDN, cb + c0 * c_ss, c_ss, NCH, L);
    load_rows(xs, LDP, xb + c0 * x_ss, x_ss, PCH, L);  // head 0, buffer 0
    cp_async_commit();
    for (int idx = tid; idx < G * QR; idx += blockDim.x) {
      const int r = idx / G;
      const int g = idx - r * G;
      dts[g * QR + r] = (r < L && g < nh) ? db[(c0 + r) * d_ss + g * d_sh] : 0.f;
    }
    __syncthreads();
    // cum = inclusive prefix sum of dt * a * log2(e), one warp a head
    for (int g = warp; g < G; g += nwarps) {
      constexpr int E = kMaxChunk / 32;  // rows a lane
      const float ah = g < nh ? a[h0 + g] * kLog2e : 0.f;
      const float* dg = dts + g * QR;
      float v[E];
      float run = 0.f;
#pragma unroll
      for (int e = 0; e < E; ++e) {
        const int r = lane * E + e;
        run += r < QR ? dg[r] * ah : 0.f;
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
        if (r < QR) cum[g * QR + r] = before + v[e];
      }
    }
    __syncthreads();
    if (!last) {
      for (int idx = tid; idx < G * QR; idx += blockDim.x) {
        const int g = idx / QR;
        scs[idx] = exp2f(cum[g * QR + QR - 1] - cum[idx]) * dts[idx];
      }
    }
    cp_async_wait<0>();
    __syncthreads();

    // this warp's rows of C B^T, key tiles at or below its last row, once for
    // every head of the group
    float cbt[MAXT][4];
#pragma unroll
    for (int j = 0; j < MAXT; ++j) cbt[j][0] = cbt[j][1] = cbt[j][2] = cbt[j][3] = 0.f;
    if (active) {
#pragma unroll
      for (int kk = 0; kk < KN; ++kk) {
        uint32_t af[4];
        ldmatrix_x4(af, cs + (q0 + lane % 16) * LDN + kk * 16 + (lane / 16) * 8);
#pragma unroll
        for (int nn = 0; nn < MAXT; nn += 2) {
          if (nn <= 2 * rt) {
            uint32_t bfr[4];  // B fragments of key tiles nn, nn + 1
            ldmatrix_x4(bfr, bs + (nn * 8 + lane % 8 + (lane / 16) * 8) * LDN
                                 + kk * 16 + ((lane / 8) % 2) * 8);
            mma_bf16(cbt[nn], af, bfr[0], bfr[1]);
            mma_bf16(cbt[nn + 1], af, bfr[2], bfr[3]);
          }
        }
      }
    }

    for (int g = 0; g < nh; ++g) {
      const int buf = nbuf == 2 ? (g & 1) : 0;
      if (nbuf == 2 && g + 1 < nh) {  // head g+1's x loads while head g computes
        load_rows(xs + ((g + 1) & 1) * QR * LDP, LDP, xb + c0 * x_ss + (g + 1) * x_sh, x_ss,
                  PCH, L);
        cp_async_commit();
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
      __syncthreads();
      const bf16* xt = xs + buf * QR * LDP;
      const float* cg = cum + g * QR;
      const float* dg = dts + g * QR;
      float* hg = hs + g * P * LDH;
      if (active) {
        float acc[PT][4];
#pragma unroll
        for (int i = 0; i < PT; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;
        const float cum0 = cg[r_lo];
        const float cum1 = cg[r_lo + 8];
        if (!first) {  // exp(cum_q) C h^T, h split hi + lo
#pragma unroll
          for (int kk = 0; kk < KN; ++kk) {
            uint32_t af[4];
            ldmatrix_x4(af, cs + (q0 + lane % 16) * LDN + kk * 16 + (lane / 16) * 8);
#pragma unroll
            for (int pt = 0; pt < PT; ++pt) {
              const float* hr = hg + (pt * 8 + lane / 4) * LDH + kk * 16 + 2 * (lane % 4);
              const float2 e0 = *reinterpret_cast<const float2*>(hr);
              const float2 e1 = *reinterpret_cast<const float2*>(hr + 8);
              uint32_t hi0, lo0, hi1, lo1;
              split_pack(e0.x, e0.y, hi0, lo0);
              split_pack(e1.x, e1.y, hi1, lo1);
              mma_bf16(acc[pt], af, hi0, hi1);
              mma_bf16(acc[pt], af, lo0, lo1);
            }
          }
          const float s0 = exp2f(cum0);
          const float s1 = exp2f(cum1);
#pragma unroll
          for (int pt = 0; pt < PT; ++pt) {
            acc[pt][0] *= s0; acc[pt][1] *= s0; acc[pt][2] *= s1; acc[pt][3] *= s1;
          }
        }
        // y += w x, w = C B^T * exp2(cum_q - cum_k) * dt_k over k <= q, split hi + lo
#pragma unroll
        for (int kk = 0; kk < kMmaMaxWarps; ++kk) {
          if (kk <= rt) {
            uint32_t ahi[4], alo[4];
#pragma unroll
            for (int half = 0; half < 2; ++half) {
              const int j = 2 * kk + half;
              const int col = j * 8 + 2 * (lane % 4);
              const float2 ck = *reinterpret_cast<const float2*>(cg + col);
              const float2 dk = *reinterpret_cast<const float2*>(dg + col);
              const float w0 = col <= r_lo ? cbt[j][0] * ex2_ftz(cum0 - ck.x) * dk.x : 0.f;
              const float w1 = col + 1 <= r_lo ? cbt[j][1] * ex2_ftz(cum0 - ck.y) * dk.y : 0.f;
              const float w2 = col <= r_lo + 8 ? cbt[j][2] * ex2_ftz(cum1 - ck.x) * dk.x : 0.f;
              const float w3 = col + 1 <= r_lo + 8 ? cbt[j][3] * ex2_ftz(cum1 - ck.y) * dk.y : 0.f;
              split_pack(w0, w1, ahi[2 * half], alo[2 * half]);
              split_pack(w2, w3, ahi[2 * half + 1], alo[2 * half + 1]);
            }
#pragma unroll
            for (int pt = 0; pt < PT; pt += 2) {
              uint32_t bfr[4];  // x fragments of column tiles pt, pt + 1
              ldmatrix_x4_trans(bfr, xt + (kk * 16 + lane % 16) * LDP + pt * 8 + (lane / 16) * 8);
              mma_bf16(acc[pt], ahi, bfr[0], bfr[1]);
              mma_bf16(acc[pt], alo, bfr[0], bfr[1]);
              mma_bf16(acc[pt + 1], ahi, bfr[2], bfr[3]);
              mma_bf16(acc[pt + 1], alo, bfr[2], bfr[3]);
            }
          }
        }
        // stage the warp's 16 rows, then 16-byte stores
        bf16* yw = ys + q0 * LDP;
#pragma unroll
        for (int pt = 0; pt < PT; ++pt) {
          const int col = pt * 8 + 2 * (lane % 4);
          *reinterpret_cast<uint32_t*>(yw + (lane / 4) * LDP + col) =
              pack_bf16(acc[pt][0], acc[pt][1]);
          *reinterpret_cast<uint32_t*>(yw + (lane / 4 + 8) * LDP + col) =
              pack_bf16(acc[pt][2], acc[pt][3]);
        }
        __syncwarp();
        bf16* yo = yb + c0 * y_ss + g * y_sh;
        for (int idx = lane; idx < 16 * PCH; idx += 32) {
          const int r = idx / PCH;
          const int c = idx - r * PCH;
          if (q0 + r < L)
            *reinterpret_cast<uint4*>(yo + (q0 + r) * y_ss + c * 8) =
                *reinterpret_cast<const uint4*>(yw + r * LDP + c * 8);
        }
      }
      if (!last) {  // block-uniform: h_g = h_g exp2(total) + x^T (B sc), B sc split hi + lo
        __syncthreads();  // every warp has read h_g
        const float keep = exp2f(cg[QR - 1]);
        const float* sg = scs + g * QR;
        constexpr int NT8 = N / 8;
        for (int t = warp; t < (P / 16) * NT8; t += nwarps) {
          const int mt = t / NT8;
          const int nt = t - mt * NT8;
          float acc4[4] = {0.f, 0.f, 0.f, 0.f};
          const int n = nt * 8 + lane / 4;
          for (int kk = 0; kk * 16 < L; ++kk) {  // keys; rows past L are zero
            uint32_t af[4];  // x^T: rows p, columns k
            ldmatrix_x4_trans(af, xt + (kk * 16 + lane % 8 + (lane / 16) * 8) * LDP
                                      + mt * 16 + ((lane / 8) % 2) * 8);
            const int k = kk * 16 + 2 * (lane % 4);
            uint32_t hi0, lo0, hi1, lo1;
            split_pack(__bfloat162float(bs[k * LDN + n]) * sg[k],
                       __bfloat162float(bs[(k + 1) * LDN + n]) * sg[k + 1], hi0, lo0);
            split_pack(__bfloat162float(bs[(k + 8) * LDN + n]) * sg[k + 8],
                       __bfloat162float(bs[(k + 9) * LDN + n]) * sg[k + 9], hi1, lo1);
            mma_bf16(acc4, af, hi0, hi1);
            mma_bf16(acc4, af, lo0, lo1);
          }
          const int p = mt * 16 + lane / 4;
          const int col = nt * 8 + 2 * (lane % 4);
          float* h0r = hg + p * LDH + col;
          float* h1r = hg + (p + 8) * LDH + col;
          if (first) {
            h0r[0] = acc4[0]; h0r[1] = acc4[1]; h1r[0] = acc4[2]; h1r[1] = acc4[3];
          } else {
            h0r[0] = fmaf(h0r[0], keep, acc4[0]); h0r[1] = fmaf(h0r[1], keep, acc4[1]);
            h1r[0] = fmaf(h1r[0], keep, acc4[2]); h1r[1] = fmaf(h1r[1], keep, acc4[3]);
          }
        }
      }
      __syncthreads();  // the x buffer and the y staging are reused
      if (nbuf == 1 && g + 1 < nh) {
        load_rows(xs, LDP, xb + c0 * x_ss + (g + 1) * x_sh, x_ss, PCH, L);
        cp_async_commit();
      }
    }
  }
}

// ----------------------------------------------------------------- launch
struct Args {
  const void* x; const void* dt; const void* a; const void* bm; const void* cm; void* y;
  int B, S, H, Q, G, hpg;
  const long long* st;
  int device;
  cudaStream_t stream;
};

template <typename T, int P, int N>
int launch(const Args& a) {
  const int smem = smem_floats(P, N, a.Q) * static_cast<int>(sizeof(float));
  cudaError_t err = cudaFuncSetAttribute(ssd_scan_kernel<T, P, N>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long* st = a.st;
  ssd_scan_kernel<T, P, N><<<a.B * a.H, kThreads, smem, a.stream>>>(
      static_cast<const T*>(a.x), static_cast<const float*>(a.dt),
      static_cast<const float*>(a.a), static_cast<const T*>(a.bm),
      static_cast<const T*>(a.cm), static_cast<T*>(a.y), a.S, a.H, a.Q, a.hpg,
      st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7], st[8], st[9],
      st[10], st[11], st[12], st[13], st[14]);
  return 0;
}

template <int P, int N>
int launch_mma(const Args& a) {
  if (a.G < 1 || a.G > kMaxHeadsPerBlock || a.hpg % a.G != 0) return -1;
  const int nwarps = (a.Q + 15) / 16;
  const int QR = nwarps * 16;
  const bool carry = a.S > a.Q;
  int nbuf = 2;  // one x buffer when two do not fit (P = N = 128 with a carried state)
  if (mma_smem(P, N, QR, a.G, nbuf, carry).total > kMaxSmem) nbuf = 1;
  const int smem = mma_smem(P, N, QR, a.G, nbuf, carry).total;
  if (smem > kMaxSmem) return -4;
  static bool opted[64] = {};  // the most a block may use, once per device
  if (a.device < 0 || a.device >= 64) return -1;
  if (!opted[a.device]) {
    cudaError_t err = cudaFuncSetAttribute(ssd_mma_kernel<P, N>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
    if (err != cudaSuccess) return static_cast<int>(err);
    opted[a.device] = true;
  }
  const long long* st = a.st;
  const int n_groups = (a.H + a.G - 1) / a.G;
  ssd_mma_kernel<P, N><<<a.B * n_groups, nwarps * 32, smem, a.stream>>>(
      static_cast<const bf16*>(a.x), static_cast<const float*>(a.dt),
      static_cast<const float*>(a.a), static_cast<const bf16*>(a.bm),
      static_cast<const bf16*>(a.cm), static_cast<bf16*>(a.y), a.S, a.H, a.Q, a.G, nbuf,
      a.hpg, st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7], st[8], st[9],
      st[10], st[11], st[12], st[13], st[14]);
  return 0;
}

template <typename T, int P>
int dispatch_n(int N, const Args& a) {
  switch (N) {
    case 8: return launch<T, P, 8>(a);
    case 16: return launch<T, P, 16>(a);
    case 32: return launch<T, P, 32>(a);
    case 64: return launch<T, P, 64>(a);
    case 128: return launch<T, P, 128>(a);
    default: return -2;
  }
}

int dispatch_f32(int P, int N, const Args& a) {
  switch (P) {
    case 8: return dispatch_n<float, 8>(N, a);
    case 16: return dispatch_n<float, 16>(N, a);
    case 32: return dispatch_n<float, 32>(N, a);
    case 64: return dispatch_n<float, 64>(N, a);
    case 128: return dispatch_n<float, 128>(N, a);
    default: return -2;
  }
}

template <int P>
int dispatch_mma_n(int N, const Args& a) {
  switch (N) {
    case 16: return launch_mma<P, 16>(a);
    case 32: return launch_mma<P, 32>(a);
    case 64: return launch_mma<P, 64>(a);
    case 128: return launch_mma<P, 128>(a);
    default: return -2;
  }
}

// bf16: the tensor-core kernel at P, N >= 16, the CUDA-core one at P or N = 8
int dispatch_bf16(int P, int N, const Args& a) {
  if (P == 8) return dispatch_n<bf16, 8>(N, a);
  if (N == 8) {
    switch (P) {
      case 16: return launch<bf16, 16, 8>(a);
      case 32: return launch<bf16, 32, 8>(a);
      case 64: return launch<bf16, 64, 8>(a);
      case 128: return launch<bf16, 128, 8>(a);
      default: return -2;
    }
  }
  switch (P) {
    case 16: return dispatch_mma_n<16>(N, a);
    case 32: return dispatch_mma_n<32>(N, a);
    case 64: return dispatch_mma_n<64>(N, a);
    case 128: return dispatch_mma_n<128>(N, a);
    default: return -2;
  }
}

}  // namespace

extern "C" {

// Returns 0 on success, a negative code for arguments the kernel does not
// take (-1 bad sizes, chunk, groups or heads a block, -2 P or N, -3 dtype,
// -4 too much shared memory for the heads a block), else the cudaError_t of
// the launch. heads_per_block is read by the bf16 tensor-core kernel only,
// and must divide heads_per_group (H / the B/C groups). Strides, in
// elements: x (batch, seq, head), dt (batch, seq, head), B (batch, seq,
// group), C (batch, seq, group), y (batch, seq, head).
int ssd_scan_fwd(const void* x, const void* dt, const void* a, const void* bm,
                 const void* cm, void* y, int dtype, int B, int S, int H, int P, int N,
                 int chunk, int heads_per_block, int heads_per_group, long long x_sb,
                 long long x_ss, long long x_sh, long long d_sb, long long d_ss,
                 long long d_sh, long long b_sb, long long b_ss, long long b_sg,
                 long long c_sb, long long c_ss, long long c_sg, long long y_sb,
                 long long y_ss, long long y_sh, int device, void* stream) {
  if (B <= 0 || S <= 0 || H <= 0 || chunk <= 0 || chunk > kMaxChunk) return -1;
  if (heads_per_group <= 0 || H % heads_per_group != 0) return -1;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long st[15] = {x_sb, x_ss, x_sh, d_sb, d_ss, d_sh,
                            b_sb, b_ss, b_sg, c_sb, c_ss, c_sg, y_sb, y_ss, y_sh};
  const Args args{x, dt, a, bm, cm, y, B, S, H, chunk, heads_per_block, heads_per_group,
                  st, device, static_cast<cudaStream_t>(stream)};
  int rc;
  if (dtype == 0) {
    rc = dispatch_f32(P, N, args);
  } else if (dtype == 1) {
    rc = dispatch_bf16(P, N, args);
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
