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
// Masked entries (j > i) are 0, not exp(-1e30 - m). For the float32 kernel
// F comes from the wrapper (torch.cumsum), as the TPU wrapper computes it
// outside its kernel; the bf16 kernel takes log f and forms F itself.
//
// Layout: q/k/v/o (B, S, H, D) and the gates (F for float32 or log f for
// bf16, and log i) (B, S, H) f32, each addressed through its own element
// strides (q/k/v/o need a contiguous last dim), so the model's head-wise
// projections and its gate split go in without a transpose, pad or copy.
//
// Bound on the H100 (3.35 TB/s, 989 TFLOP/s bf16): at xLSTM-1.3B's serving
// shape B=32, S=128, H=4, D=1024, bf16, the call moves ~134 MB (q, k, v
// and o, 33.5 MB each), ~0.040 ms, against ~4.3 GFLOP of causal work
// (two S x S x D products), ~0.004 ms: bytes bound.
//
// Both designs take the stabiliser from the gates alone: m_i is the prefix
// maximum of log i_j - F_j, plus F_i, so a block computes it exactly before
// it touches k and v, and no running-max rescale of the (signed) numerator
// and denominator is needed, unlike the TPU kernel's online update.
//
// bf16 (every serving run): a tensor-core kernel on mma.sync.m16n8k16
// (bf16 in, f32 accumulate). D = 1024 is the hard case: a 64-row f32
// accumulator of the full D is 256 KB, more than a block may use, so the
// output's D is split across the blocks of a thread-block cluster.
// * One block of 4 warps per (query tile of 64 rows, slice of DS = min(D,
//   128) output columns, batch * head); the D / DS <= 8 slices of a query
//   tile form one cluster. Each warp owns 16 query rows.
// * Per key tile of 64 keys (causal: tiles past the query tile are never
//   visited), each block computes the partial scores q . k^T over its own
//   D-slice on the tensor cores (q and k by 16-byte cp.async into padded
//   tiles, ldmatrix; key tiles wholly above a warp's rows skipped). The
//   cluster sums the partial (64 x 64) f32 scores through distributed
//   shared memory: block r sums rows [r 64 / CS, (r + 1) 64 / CS) over the
//   cluster (in rank order, so every block gets the same bits), then each
//   lane reads the sums of its fragments from the blocks that hold them. No
//   q . k^T is recomputed across slices; with one slice (D <= 128) the
//   scores stay in registers.
// * F = cumsum(log f) is formed in the kernel, a key tile at a time by one
//   warp, with one routine for the stabiliser's pass and the main loop, so
//   both see the same F (the wrapper launches nothing else). The
//   stabiliser is m_i = F_i + max_{j <= i} (log i_j - F_j), over the gates
//   of the key tiles in shared memory, two threads a row.
// * Each block then forms w = score / sqrt(D) * exp(b - m) in registers
//   (the exponent by ex2.approx.ftz, 6% faster than expf at the serving
//   shape),
//   adds w to the row sums (den), splits w into bf16 hi = bf16(w) and lo =
//   bf16(w - hi), and runs w_hi v + w_lo v for its own columns (v by
//   ldmatrix.trans; the split keeps w to ~2^-16 of itself, near f32). K and
//   V tiles are single-buffered and overlapped: the next K tile loads
//   during this tile's reduction and w . v, the next V tile during the next
//   scores. The epilogue divides by max(|den|, exp(-m)) and writes through
//   a staging tile with 16-byte stores.
// What it does about the previous design's costs: (1) q . k^T on the
// tensor cores, not 16 chains of warp shuffles a key; (2) 128-thread blocks
// of 73 KB (at D = 1024), three an SM, in place of one 256-thread block of 182
// registers; (3) each block reads its D-slice of q, k and v once, so K/V
// reads drop from ~4.5x to ~1.5x (two 64-row query tiles), and v moves in
// 16-byte loads; (4) 2,048 blocks of 128 threads at the serving shape,
// several an SM.
//
// float32 (tests and the reduced models; no serving run): the first
// version's CUDA-core kernel, exact f32, unchanged:
// * 16-row query tiles: the 16 x D f32 accumulator lives in registers, 64
//   a thread over 256 threads, and the 16 x D f32 q tile in dynamic shared
//   memory.
// * One block of 256 threads per (16-row query tile, batch * head). Per key
//   tile of 32 keys: each warp takes keys in turn, holds the key row in
//   registers (D / 32 values a lane), and forms its dot products with the
//   16 q rows (lane-strided, conflict-free shared reads, five
//   xor-shuffles); lane 0 writes the weight w_ij into a 16 x 32 shared
//   tile. Then every thread adds w_ij v_j into its rows and columns of the
//   accumulator and w_ij into its rows' denominators. Key tiles past the
//   query tile's last row are never visited (causal skip).
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "tensor_core.cuh"

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

// --------------------------------------------------- bf16, tensor cores
namespace cg = cooperative_groups;

// 4 bytes global -> shared (a gate); pred false writes zeros, reads nothing
__device__ __forceinline__ void cp_async4(void* smem, const void* gmem, bool pred) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  const int n = pred ? 4 : 0;
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(s), "l"(gmem), "r"(n));
}

constexpr float kLog2e = 1.4426950408889634f;

// F = cumsum(log f) over one 64-key tile, in one warp: lane l holds keys 2l
// and 2l + 1 of g (raw log f in, F out, in place), carry is F before the
// tile (the same in every lane) and comes back as F at the tile's last key.
// The stabiliser's pass and the main loop both form F with this, so they
// see the same bits.
__device__ __forceinline__ void scan_tile(float* g, float& carry, int lane) {
  const float2 v = *reinterpret_cast<const float2*>(g + 2 * lane);
  const float pair = v.x + v.y;
  float incl = pair;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const float t = __shfl_up_sync(0xffffffffu, incl, off);
    if (lane >= off) incl += t;
  }
  float before = __shfl_up_sync(0xffffffffu, incl, 1);  // the lanes before
  if (lane == 0) before = 0.f;
  const float f0 = (carry + before) + v.x;
  const float f1 = f0 + v.y;
  *reinterpret_cast<float2*>(g + 2 * lane) = make_float2(f0, f1);
  carry = __shfl_sync(0xffffffffu, f1, 31);
}

constexpr int kMmaWarps = 4;                 // 16 query rows a warp
constexpr int kMmaBlockQ = 16 * kMmaWarps;   // query rows a block
constexpr int kMmaBlockK = 64;               // keys a tile
constexpr int kMmaThreads = kMmaWarps * 32;

// q, K and V tiles (bf16, rows padded by 8), the key tiles' gates (two
// buffers, and one for the stabiliser's pass), F_i and m_i; with a cluster,
// the (64 x 64) f32 partial score tile and this block's rows of their sum
template <int DS, int CS>
constexpr int mma_smem_bytes() {
  return 3 * kMmaBlockQ * (DS + 8) * 2 + (6 * kMmaBlockK + 2 * kMmaBlockQ) * 4
         + (CS > 1 ? (kMmaBlockQ * (kMmaBlockK + 8) + kMmaBlockQ / CS * kMmaBlockK) * 4 : 0);
}

template <int DS, int CS>
__global__ void __launch_bounds__(kMmaThreads, 3)
mlstm_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                 const bf16* __restrict__ v, const float* __restrict__ logf,
                 const float* __restrict__ logi, bf16* __restrict__ o, int S, int H,
                 int64_t q_sb, int64_t q_ss, int64_t q_sh,
                 int64_t k_sb, int64_t k_ss, int64_t k_sh,
                 int64_t v_sb, int64_t v_ss, int64_t v_sh,
                 int64_t f_sb, int64_t f_ss, int64_t f_sh,
                 int64_t l_sb, int64_t l_ss, int64_t l_sh,
                 int64_t o_sb, int64_t o_ss, int64_t o_sh, float inv_sqrt_d) {
  constexpr int BQ = kMmaBlockQ;
  constexpr int BK = kMmaBlockK;
  constexpr int LD = DS + 8;     // padded bf16 row of the q, K and V tiles
  constexpr int CH = DS / 8;     // 16-byte chunks a row
  constexpr int KS = DS / 16;    // k-steps of the partial q . k^T
  constexpr int NT = BK / 8;     // 8-key n-tiles of the scores
  constexpr int DT = DS / 8;     // 8-column n-tiles of the output slice
  constexpr int LDS = BK + 8;    // padded f32 row of the score tile
  constexpr int RPR = BQ / CS;   // score rows each block of the cluster sums
  static_assert(DS % 16 == 0 && BQ == BK && BQ % CS == 0, "tiling");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* qs = reinterpret_cast<bf16*>(smem_raw);          // [BQ][LD]
  bf16* ks = qs + BQ * LD;                               // [BK][LD]
  bf16* vs = ks + BK * LD;                               // [BK][LD]
  float* fk = reinterpret_cast<float*>(vs + BK * LD);    // [2][BK] log f_j, then F_j
  float* lk = fk + 2 * BK;                               // [2][BK] log i_j
  float* gf = lk + 2 * BK;                               // [BK] log f_j, then F_j: the
                                                         // stabiliser's pass
  float* gl = gf + BK;                                   // [BK] log i_j, the same
  float* fq = gl + BK;                                   // [BQ] F_i
  float* mq = fq + BQ;                                   // [BQ] m_i
  float* part = mq + BQ;                                 // [BQ][LDS] (cluster only)
  float* red = part + BQ * LDS;                          // [RPR][BK] (cluster only)

  const int slice = blockIdx.x;  // the block's rank in its cluster
  const int q0 = blockIdx.y * BQ;
  const int bh = blockIdx.z;
  const int b = bh / H;
  const int h = bh - b * H;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int d0 = slice * DS;

  const bf16* qb = q + b * q_sb + h * q_sh + d0;
  const bf16* kb = k + b * k_sb + h * k_sh + d0;
  const bf16* vb = v + b * v_sb + h * v_sh + d0;
  const float* fb = logf + b * f_sb + h * f_sh;
  const float* lb = logi + b * l_sb + h * l_sh;

  // rows [row0, row0 + 64) of src's slice into dst, zeros past S
  auto load_rows = [&](bf16* dst, const bf16* src, int64_t row_stride, int row0) {
    for (int idx = tid; idx < 64 * CH; idx += kMmaThreads) {
      const int r = idx / CH;
      const int c = idx - r * CH;
      const int pos = row0 + r;
      const bool ok = pos < S;
      cp_async16(dst + r * LD + c * 8, src + (ok ? pos : 0) * row_stride + c * 8, ok);
    }
  };

  // key j's gates log f_j and log i_j into buffer buf, zeros past S
  auto load_gates = [&](int buf, int k0) {
    const int jj = tid % BK;
    const int j = k0 + jj;
    const bool ok = j < S;
    if (tid < BK) {
      cp_async4(fk + buf * BK + jj, fb + (ok ? j : 0) * f_ss, ok);
    } else {
      cp_async4(lk + buf * BK + jj, lb + (ok ? j : 0) * l_ss, ok);
    }
  };
  static_assert(kMmaThreads == 2 * BK && kMmaThreads == 2 * BQ, "two threads a key, a row");

  // causal: key tiles past this query tile's last row are never visited
  const int k_end = min(S, q0 + BQ);
  const int n_tiles = (k_end + BK - 1) / BK;
  load_rows(qs, qb, q_ss, q0);
  load_rows(ks, kb, k_ss, 0);
  load_gates(0, 0);
  cp_async_commit();  // q, K_0 and its gates
  load_rows(vs, vb, v_ss, 0);
  cp_async_commit();  // V_0

  // F = cumsum(log f) and the exact stabiliser m_i = F_i + max_{j <= i}
  // (log i_j - F_j), while the tiles load: a key tile's gates at a time in
  // shared memory, F scanned by warp 0, two threads a row with 32 keys each.
  // The query tile is the last key tile, so F_i comes with it.
  {
    const int r = tid / 2;
    const int i = q0 + r;
    const int j0 = (tid % 2) * (BK / 2);
    float carry = 0.f;
    float mx = kNegInf;
    for (int t = 0; t < n_tiles; ++t) {
      const int k0 = t * BK;
      const int j = k0 + tid % BK;
      __syncthreads();  // the previous key tile's gates are read
      if (tid < BK) {
        gf[tid] = j < S ? fb[j * f_ss] : 0.f;
      } else {
        gl[tid - BK] = j < S ? lb[j * l_ss] : 0.f;
      }
      __syncthreads();
      if (warp == 0) scan_tile(gf, carry, lane);
      __syncthreads();
      const int last = i - k0;  // keys j <= i of this tile; every tile starts at or before i
#pragma unroll 8
      for (int jj = j0; jj < j0 + BK / 2; ++jj)
        if (jj <= last) mx = fmaxf(mx, gl[jj] - gf[jj]);
    }
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    if (tid % 2 == 0) {
      const float fi = gf[r];
      fq[r] = fi;
      mq[r] = i < S ? fi + mx : 0.f;
    }
  }
  float carry = 0.f;  // F before the main loop's key tile (warp 0)

  const int wrow0 = q0 + warp * 16;     // this warp's first query row
  const int row_lo = wrow0 + lane / 4;  // fragment rows row_lo and row_lo + 8
  const bool ok0 = row_lo < S;
  const bool ok1 = row_lo + 8 < S;
  float acc[DT][4];
#pragma unroll
  for (int i = 0; i < DT; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;
  float den0 = 0.f, den1 = 0.f;  // this lane's part of the row sums of w
  float f0 = 0.f, f1 = 0.f, m0 = 0.f, m1 = 0.f;

  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * BK;
    const bool more = t + 1 < n_tiles;
    float* ft = fk + (t & 1) * BK;  // this key tile's gates
    const float* lt = lk + (t & 1) * BK;
    cp_async_wait<1>();  // q, K_t and its gates are in; V_t may still be in flight
    __syncthreads();
    if (warp == 0) scan_tile(ft, carry, lane);  // read after the next barrier
    if (t == 0) {
      f0 = fq[row_lo - q0];
      f1 = fq[row_lo + 8 - q0];
      m0 = mq[row_lo - q0];
      m1 = mq[row_lo + 8 - q0];
    }
    // partial scores over this block's D-slice; key tiles wholly above the
    // warp's rows are skipped (left 0, masked below)
    float s[NT][4];
#pragma unroll
    for (int i = 0; i < NT; ++i) s[i][0] = s[i][1] = s[i][2] = s[i][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      uint32_t af[4];
      ldmatrix_x4(af, qs + (warp * 16 + lane % 16) * LD + kk * 16 + (lane / 16) * 8);
#pragma unroll
      for (int nn = 0; nn < NT; nn += 2) {
        if (k0 + nn * 8 <= wrow0 + 15) {  // warp-uniform
          uint32_t bfr[4];  // B fragments of key tiles nn, nn + 1
          ldmatrix_x4(bfr, ks + (nn * 8 + lane % 8 + (lane / 16) * 8) * LD
                               + kk * 16 + ((lane / 8) % 2) * 8);
          mma_bf16(s[nn], af, bfr[0], bfr[1]);
          mma_bf16(s[nn + 1], af, bfr[2], bfr[3]);
        }
      }
    }
    if constexpr (CS > 1) {
      // the cluster sums its blocks' partial scores through distributed
      // shared memory: block r sums rows [r RPR, (r + 1) RPR), in rank order,
      // then every block reads the sums of its fragments' rows
      cg::cluster_group cluster = cg::this_cluster();
      float* pw = part + (warp * 16 + lane / 4) * LDS + 2 * (lane % 4);
#pragma unroll
      for (int nn = 0; nn < NT; ++nn) {
        *reinterpret_cast<float2*>(pw + nn * 8) = make_float2(s[nn][0], s[nn][1]);
        *reinterpret_cast<float2*>(pw + 8 * LDS + nn * 8) = make_float2(s[nn][2], s[nn][3]);
      }
      cluster.sync();  // every block's partial scores are in; K_t is read
      if (more) {
        load_rows(ks, kb, k_ss, k0 + BK);
        load_gates((t + 1) & 1, k0 + BK);
        cp_async_commit();
      }
      const int rank = static_cast<int>(cluster.block_rank());
      static_assert((RPR * (BK / 4)) % kMmaThreads == 0, "reduce");
#pragma unroll
      for (int it = 0; it < RPR * (BK / 4) / kMmaThreads; ++it) {
        const int idx = tid + it * kMmaThreads;
        const int r = idx / (BK / 4);
        const int c = (idx - r * (BK / 4)) * 4;
        float4 sum = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
        for (int j = 0; j < CS; ++j) {
          const float4 p4 = *reinterpret_cast<const float4*>(
              cluster.map_shared_rank(part, j) + (rank * RPR + r) * LDS + c);
          sum.x += p4.x;
          sum.y += p4.y;
          sum.z += p4.z;
          sum.w += p4.w;
        }
        *reinterpret_cast<float4*>(red + r * BK + c) = sum;
      }
      cluster.sync();  // the sums are ready; no block reads part any more
      // this lane's fragments of the sums, from the blocks that hold their rows
      const int ra = warp * 16 + lane / 4;  // rows ra and ra + 8
      const float* sa = cluster.map_shared_rank(red, ra / RPR) + (ra % RPR) * BK
                        + 2 * (lane % 4);
      const float* sb = cluster.map_shared_rank(red, (ra + 8) / RPR) + ((ra + 8) % RPR) * BK
                        + 2 * (lane % 4);
#pragma unroll
      for (int nn = 0; nn < NT; ++nn) {
        const float2 e0 = *reinterpret_cast<const float2*>(sa + nn * 8);
        const float2 e1 = *reinterpret_cast<const float2*>(sb + nn * 8);
        s[nn][0] = e0.x;
        s[nn][1] = e0.y;
        s[nn][2] = e1.x;
        s[nn][3] = e1.y;
      }
    } else {
      __syncthreads();  // K_t is read
      if (more) {
        load_rows(ks, kb, k_ss, k0 + BK);
        load_gates((t + 1) & 1, k0 + BK);
        cp_async_commit();
      }
    }
    if (more) {
      cp_async_wait<1>();  // V_t is in; K_{t+1} may still be in flight
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    // w = score / sqrt(D) * exp(b - m) over j <= i < S, its row sums, and
    // w_hi v + w_lo v for this block's columns
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      if (k0 + kk * 16 <= wrow0 + 15) {  // warp-uniform
        uint32_t ahi[4], alo[4];
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int nn = 2 * kk + half;
          const int jj = nn * 8 + 2 * (lane % 4);
          const int col = k0 + jj;
          const float2 fj = *reinterpret_cast<const float2*>(ft + jj);
          const float2 lj = *reinterpret_cast<const float2*>(lt + jj);
          const float w0 = ok0 && col <= row_lo
              ? s[nn][0] * inv_sqrt_d * ex2_ftz((((f0 - fj.x) + lj.x) - m0) * kLog2e) : 0.f;
          const float w1 = ok0 && col + 1 <= row_lo
              ? s[nn][1] * inv_sqrt_d * ex2_ftz((((f0 - fj.y) + lj.y) - m0) * kLog2e) : 0.f;
          const float w2 = ok1 && col <= row_lo + 8
              ? s[nn][2] * inv_sqrt_d * ex2_ftz((((f1 - fj.x) + lj.x) - m1) * kLog2e) : 0.f;
          const float w3 = ok1 && col + 1 <= row_lo + 8
              ? s[nn][3] * inv_sqrt_d * ex2_ftz((((f1 - fj.y) + lj.y) - m1) * kLog2e) : 0.f;
          den0 += w0 + w1;
          den1 += w2 + w3;
          split_pack(w0, w1, ahi[2 * half], alo[2 * half]);
          split_pack(w2, w3, ahi[2 * half + 1], alo[2 * half + 1]);
        }
#pragma unroll
        for (int dt = 0; dt < DT; dt += 2) {
          uint32_t bfr[4];  // V fragments of column tiles dt, dt + 1
          ldmatrix_x4_trans(bfr, vs + (kk * 16 + lane % 16) * LD + dt * 8 + (lane / 16) * 8);
          mma_bf16(acc[dt], ahi, bfr[0], bfr[1]);
          mma_bf16(acc[dt], alo, bfr[0], bfr[1]);
          mma_bf16(acc[dt + 1], ahi, bfr[2], bfr[3]);
          mma_bf16(acc[dt + 1], alo, bfr[2], bfr[3]);
        }
      }
    }
    __syncthreads();  // V_t is read
    if (more) {
      load_rows(vs, vb, v_ss, k0 + BK);
      cp_async_commit();
    }
  }

  // y_i = num_i / max(|den_i|, exp(-m_i)); stage the warp's 16 rows in its
  // own rows of the q tile (read only by this warp), then 16-byte stores
  den0 += __shfl_xor_sync(0xffffffffu, den0, 1);
  den0 += __shfl_xor_sync(0xffffffffu, den0, 2);
  den1 += __shfl_xor_sync(0xffffffffu, den1, 1);
  den1 += __shfl_xor_sync(0xffffffffu, den1, 2);
  const float n0 = fmaxf(fabsf(den0), expf(-m0));
  const float n1 = fmaxf(fabsf(den1), expf(-m1));
  bf16* ow = qs + warp * 16 * LD;
  __syncwarp();
#pragma unroll
  for (int dt = 0; dt < DT; ++dt) {
    const int col = dt * 8 + 2 * (lane % 4);
    *reinterpret_cast<uint32_t*>(ow + (lane / 4) * LD + col) =
        pack_bf16(acc[dt][0] / n0, acc[dt][1] / n0);
    *reinterpret_cast<uint32_t*>(ow + (lane / 4 + 8) * LD + col) =
        pack_bf16(acc[dt][2] / n1, acc[dt][3] / n1);
  }
  __syncwarp();
  bf16* ob = o + b * o_sb + h * o_sh + d0;
  for (int idx = lane; idx < 16 * CH; idx += 32) {
    const int r = idx / CH;
    const int c = idx - r * CH;
    const int pos = wrow0 + r;
    if (pos < S)
      *reinterpret_cast<uint4*>(ob + pos * o_ss + c * 8) =
          *reinterpret_cast<const uint4*>(ow + r * LD + c * 8);
  }
  if constexpr (CS > 1) {
    cg::this_cluster().sync();  // the others have read this block's sums
  }
}

// ----------------------------------------------------------------- launch
// st: element strides (batch, seq, head) of q, k, v, F, log f, log i, o
struct Args {
  const void* q; const void* k; const void* v; const void* fcum; const void* logf;
  const void* l; void* o;
  int B, S, H;
  const long long* st;
  int device;
  cudaStream_t stream;
};

template <int D>
int launch_f32(const Args& a) {
  const int smem = kBlockQ * D * static_cast<int>(sizeof(float));
  cudaError_t err = cudaFuncSetAttribute(mlstm_fwd_kernel<float, D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid((a.S + kBlockQ - 1) / kBlockQ, a.B * a.H);
  const long long* st = a.st;
  mlstm_fwd_kernel<float, D><<<grid, kThreads, smem, a.stream>>>(
      static_cast<const float*>(a.q), static_cast<const float*>(a.k),
      static_cast<const float*>(a.v), static_cast<const float*>(a.fcum),
      static_cast<const float*>(a.l), static_cast<float*>(a.o), a.S, a.H,
      st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7], st[8],
      st[9], st[10], st[11], st[15], st[16], st[17], st[18], st[19], st[20],
      sqrtf(static_cast<float>(D)));
  return 0;
}

template <int DS, int CS>
int launch_mma(const Args& a) {
  constexpr int smem = mma_smem_bytes<DS, CS>();
  if (smem > 48 * 1024) {  // above 48 KB only by opting in, once per device
    static bool opted[64] = {};
    if (a.device < 0 || a.device >= 64) return -1;
    if (!opted[a.device]) {
      cudaError_t err = cudaFuncSetAttribute(mlstm_mma_kernel<DS, CS>,
                                             cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
      if (err != cudaSuccess) return static_cast<int>(err);
      opted[a.device] = true;
    }
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(CS, (a.S + kMmaBlockQ - 1) / kMmaBlockQ, a.B * a.H);
  cfg.blockDim = dim3(kMmaThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = a.stream;
  cudaLaunchAttribute cluster[1];
  cluster[0].id = cudaLaunchAttributeClusterDimension;
  cluster[0].val.clusterDim.x = CS;  // the D-slices of a (query tile, batch * head)
  cluster[0].val.clusterDim.y = 1;
  cluster[0].val.clusterDim.z = 1;
  cfg.attrs = cluster;
  cfg.numAttrs = CS > 1 ? 1 : 0;
  const long long* st = a.st;
  return static_cast<int>(cudaLaunchKernelEx(
      &cfg, mlstm_mma_kernel<DS, CS>, static_cast<const bf16*>(a.q),
      static_cast<const bf16*>(a.k), static_cast<const bf16*>(a.v),
      static_cast<const float*>(a.logf), static_cast<const float*>(a.l),
      static_cast<bf16*>(a.o), a.S, a.H,
      static_cast<int64_t>(st[0]), static_cast<int64_t>(st[1]), static_cast<int64_t>(st[2]),
      static_cast<int64_t>(st[3]), static_cast<int64_t>(st[4]), static_cast<int64_t>(st[5]),
      static_cast<int64_t>(st[6]), static_cast<int64_t>(st[7]), static_cast<int64_t>(st[8]),
      static_cast<int64_t>(st[12]), static_cast<int64_t>(st[13]), static_cast<int64_t>(st[14]),
      static_cast<int64_t>(st[15]), static_cast<int64_t>(st[16]), static_cast<int64_t>(st[17]),
      static_cast<int64_t>(st[18]), static_cast<int64_t>(st[19]), static_cast<int64_t>(st[20]),
      1.0f / sqrtf(static_cast<float>(DS * CS))));
}

int dispatch_f32(int D, const Args& a) {
  switch (D) {
    case 32: return launch_f32<32>(a);
    case 64: return launch_f32<64>(a);
    case 128: return launch_f32<128>(a);
    case 256: return launch_f32<256>(a);
    case 512: return launch_f32<512>(a);
    case 1024: return launch_f32<1024>(a);
    default: return -2;
  }
}

// slices of min(D, 128) columns, D / slice of them a cluster
int dispatch_bf16(int D, const Args& a) {
  switch (D) {
    case 32: return launch_mma<32, 1>(a);
    case 64: return launch_mma<64, 1>(a);
    case 128: return launch_mma<128, 1>(a);
    case 256: return launch_mma<128, 2>(a);
    case 512: return launch_mma<128, 4>(a);
    case 1024: return launch_mma<128, 8>(a);
    default: return -2;
  }
}

}  // namespace

extern "C" {

// Returns 0 on success, a negative code for arguments the kernel does not
// take (-1 bad sizes or a missing gate, -2 head dim, -3 dtype), else the
// cudaError_t of the launch. The float32 kernel reads fcum, F = cumsum(log
// f); the bf16 kernel reads logf, log f itself, and forms F. The gate the
// dtype does not read may be null. Strides, in elements, are (batch, seq,
// head) for q, k, v, fcum, logf, log i and o, in that order.
int mlstm_attention_fwd(const void* q, const void* k, const void* v, const void* fcum,
                        const void* logf, const void* logi, void* o, int dtype, int B, int S,
                        int H, int D,
                        long long q_sb, long long q_ss, long long q_sh,
                        long long k_sb, long long k_ss, long long k_sh,
                        long long v_sb, long long v_ss, long long v_sh,
                        long long fc_sb, long long fc_ss, long long fc_sh,
                        long long lf_sb, long long lf_ss, long long lf_sh,
                        long long l_sb, long long l_ss, long long l_sh,
                        long long o_sb, long long o_ss, long long o_sh,
                        int device, void* stream) {
  if (B <= 0 || S <= 0 || H <= 0 || static_cast<long long>(B) * H > 65535) return -1;
  if ((dtype == 0 && fcum == nullptr) || (dtype == 1 && logf == nullptr)) return -1;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long st[21] = {q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh,
                            fc_sb, fc_ss, fc_sh, lf_sb, lf_ss, lf_sh, l_sb, l_ss, l_sh,
                            o_sb, o_ss, o_sh};
  const Args a{q, k, v, fcum, logf, logi, o, B, S, H, st, device,
               static_cast<cudaStream_t>(stream)};
  int rc;
  if (dtype == 0) {
    rc = dispatch_f32(D, a);
  } else if (dtype == 1) {
    rc = dispatch_bf16(D, a);
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
