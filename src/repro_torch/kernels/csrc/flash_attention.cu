// Prefill (flash) attention for Hopper, sm_90a. Plain C interface, loaded
// with ctypes by repro_torch/kernels/flash_attention.py.
//
// Replaces the TPU kernel src/repro/kernels/flash_attention.py::
// flash_attention_bhsd (_flash_kernel): causal or full GQA attention with
// an online softmax (running max, sum and accumulator in f32), Sq query
// rows over Sk keys, keys at or past Sk masked, kv tiles entirely above
// the diagonal skipped, the row sum clamped at 1e-30, masked scores set to
// -1e30. As in the TPU kernel the causal mask is top-left aligned, key
// position <= query position, whatever Sq and Sk are (the encoder-decoder's
// cross-attention is Sq decoder rows over Sk encoder frames, not causal).
//
// Layout: q (B, Sq, Hq, D), k/v (B, Sk, Hkv, D) and o (B, Sq, Hq, D), each
// addressed through its own element strides (the last dim must be
// contiguous), so the model's tensors go in without a transpose or copy.
// q head h reads kv head h / G (G = Hq / Hkv): GQA by indexing.
//
// Bound on the H100 (3.35 TB/s, 989 TFLOP/s bf16): at qwen2-0.5b's serving
// shape B=32, S=128, Hq=14, Hkv=2, D=64 the call moves ~16.8 MB (q and o
// 7.3 MB each, k+v 2.1 MB), ~5.0 us, against ~0.95 GFLOP of causal work,
// ~1 us at the bf16 tensor-core peak: bytes bound. At Zamba2's shared block
// (Hq = Hkv = 32) ~67 MB, ~20 us. Each q, k and v element is read from
// device memory once per block that needs it. The encoder of
// seamless-m4t-large-v2 (B=32, S=4096, Hq=Hkv=16, D=64, not causal) is the
// other way round: ~2.2 TFLOP, ~2.2 ms at the bf16 peak, against 1.07 GB,
// ~0.32 ms: bound by operations.
//
// bf16 (every serving run): a tensor-core kernel in the FlashAttention-2
// shape, on mma.sync.m16n8k16 (bf16 in, f32 accumulate). A block of 4
// warps owns 64 query rows of one (batch, q head) (measured on the H100:
// faster than 8 warps and 128 rows at both serving shapes; at D <= 64 it
// is held to 128 registers, so 4 blocks of 46 KB fit an SM, 5% faster
// than 139 registers and 3 blocks);
// each warp owns 16 rows and keeps its Q fragments in registers (loaded
// once with ldmatrix). K and V tiles of 64 rows stay bf16 in shared
// memory, loaded with 16-byte cp.async into two buffers (the next tile
// loads while this one is used); rows are padded by 16 bytes, so the eight
// row addresses of an ldmatrix fall in eight different bank quads. S = Q·Kᵀ
// accumulates in f32 fragments; the online-softmax row max and sum use
// quad shuffles on the fragments (the sum is reduced once, at the end);
// P is rounded to bf16 in registers and is the A operand of P·V, with V
// through ldmatrix.trans. Causal kv tiles above the diagonal are not
// loaded, a warp skips a tile wholly above its own rows, and the diagonal
// and ragged tiles are masked in registers (rows past Sq or Sk load as
// zeros, through cp.async's zero fill). The epilogue divides by the clamped row
// sum, stages the warp's 16 rows in its own part of the q tile and stores
// them with 16-byte stores.
//
// Head dims 16, 32, 64, 112, 128 and 192 (the TPU kernel takes any, with
// full-dim blocks; the port's models use 16 in the reduced configs, 64,
// 112 for kimi-k2, 128, and 192 for nemotron-4-340b). At D = 112 and 192
// the bf16 tile takes 75 and 125 KB of shared memory, above the 48 KB a
// launch gets without opting in; at D = 192 the Q fragments are read from
// the q tile for each kv tile instead of being held in registers, beside
// O's 96 f32 registers a thread.
//
// Where the bf16 numerics differ from the TPU kernel: the TPU kernel keeps
// p in f32 for P·V (flash_attention.py:64-67); this kernel rounds p to bf16
// before the tensor-core product (the row sum l is taken from the f32 p).
// Each output is a convex combination of bf16 values of v, weights p/l in
// [0, 1]; rounding each weight to bf16 moves it by at most 2^-8 of itself,
// so the output moves by at most 2^-8·max|v| (~0.008 for |v| <= 2), below
// the bf16 tolerance of 2e-2 the kernel is held to, and of the same order
// as rounding the output to bf16, which both kernels do. Scores are scaled
// by log2(e)/sqrt(D) and exponentiated with exp2f, the same function.
//
// Why mma.sync and not wgmma/TMA: the serving shape is bound by bytes
// (5 us against ~1 us of flops at the bf16 peak), and mma.sync's rate is a
// large multiple of what that needs. wgmma works on 64-row warpgroup tiles
// and pays off when TMA keeps a deep ring of tiles in flight; at S = 128 a
// (batch, head) has two kv tiles, leaving nothing to pipeline. Longer
// prompts are where it belongs (later work).
//
// float32 (tests and the reduced models only; no serving run uses it): the
// first version's CUDA-core loop, kept as it was so it computes in exact
// f32 — TF32 tensor cores would break the 2e-5 kernel checks and the 1e-4
// card-vs-CPU model checks. One 256-thread block per (64-row query tile,
// batch * q head); four lanes own one query row, each with a quarter of
// the head dim of q and of the f32 accumulator; a kv tile is converted to
// f32 in shared memory; two xor-shuffles finish each dot product.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "tensor_core.cuh"

namespace {

constexpr float kNegInf = -1e30f;
constexpr int kBlockQ = 64;
constexpr int kLanesPerRow = 4;
constexpr int kThreads = kBlockQ * kLanesPerRow;

// ---------------------------------------------------------------- float32
__device__ __forceinline__ float to_f32(float x) { return x; }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }

template <typename T, int D, int BK>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o,
                 int Sq, int Sk, int Hq, int group,
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
    if (qpos < Sq) {
      const T* p = qb + qpos * q_ss + d;
      x = make_float4(to_f32(p[0]), to_f32(p[1]), to_f32(p[2]), to_f32(p[3]));
    }
    qr[i] = x;
    acc[i] = make_float4(0.f, 0.f, 0.f, 0.f);
  }
  float m = kNegInf;
  float l = 0.f;

  // causal: kv tiles starting past this query tile's last row are skipped
  const int k_end = causal ? min(Sk, q0 + kBlockQ) : Sk;
  for (int k0 = 0; k0 < k_end; k0 += BK) {
    __syncthreads();  // the previous tile is no longer read
    float* ksf = reinterpret_cast<float*>(ks);
    float* vsf = reinterpret_cast<float*>(vs);
    for (int idx = tid; idx < BK * D; idx += kThreads) {
      const int j = idx / D;
      const int d = idx - j * D;
      const int kp = k0 + j;
      float kx = 0.f, vx = 0.f;
      if (kp < Sk) {
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
      const bool ok = kp < Sk && (!causal || kp <= qpos);
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

  if (qpos < Sq) {
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


// --------------------------------------------------- bf16, tensor cores
constexpr int kMmaWarps = 4;    // 16 query rows a warp
constexpr int kMmaBlockK = 64;  // kv rows per tile

template <int D>
constexpr int mma_smem_bytes() {
  return static_cast<int>(sizeof(bf16)) * (D + 8) * (16 * kMmaWarps + 4 * kMmaBlockK);
}

template <int D>
__global__ void __launch_bounds__(kMmaWarps * 32, D <= 64 ? 4 : 1)
flash_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                 const bf16* __restrict__ v, bf16* __restrict__ o,
                 int Sq, int Sk, int Hq, int group,
                 int64_t q_sb, int64_t q_ss, int64_t q_sh,
                 int64_t k_sb, int64_t k_ss, int64_t k_sh,
                 int64_t v_sb, int64_t v_ss, int64_t v_sh,
                 int64_t o_sb, int64_t o_ss, int64_t o_sh,
                 float scale_log2, int causal) {
  constexpr int BQ = 16 * kMmaWarps;
  constexpr int BK = kMmaBlockK;
  constexpr int LD = D + 8;          // padded shared-memory row (elements)
  constexpr int CH = D / 8;          // 16-byte chunks per row
  constexpr int KSTEPS = D / 16;     // k-steps of Q.K^T
  constexpr int NT = BK / 8;         // 8-column n-tiles of S
  constexpr int DT = D / 8;          // 8-column n-tiles of O
  constexpr int NTHREADS = kMmaWarps * 32;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* qs = reinterpret_cast<bf16*>(smem_raw);  // [BQ][LD]
  bf16* ks = qs + BQ * LD;                       // [2][BK][LD]
  bf16* vs = ks + 2 * BK * LD;                   // [2][BK][LD]

  const int bh = blockIdx.y;
  const int b = bh / Hq;
  const int h = bh - b * Hq;
  const int hkv = h / group;
  const int q0 = blockIdx.x * BQ;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;

  const bf16* qb = q + b * q_sb + h * q_sh;
  const bf16* kb = k + b * k_sb + hkv * k_sh;
  const bf16* vb = v + b * v_sb + hkv * v_sh;

  // rows [row0, row0 + nrows) of src into dst, zeros at and past `len`
  auto load_rows = [&](bf16* dst, const bf16* src, int64_t row_stride, int row0, int nrows,
                       int len) {
    for (int idx = tid; idx < nrows * CH; idx += NTHREADS) {
      const int r = idx / CH;
      const int c = idx - r * CH;
      const int pos = row0 + r;
      const bool ok = pos < len;
      cp_async16(dst + r * LD + c * 8, src + (ok ? pos : 0) * row_stride + c * 8, ok);
    }
  };

  // causal: kv tiles starting past this query tile's last row are skipped
  const int k_end = causal ? min(Sk, q0 + BQ) : Sk;
  const int n_tiles = (k_end + BK - 1) / BK;
  load_rows(qs, qb, q_ss, q0, BQ, Sq);
  load_rows(ks, kb, k_ss, 0, BK, Sk);
  load_rows(vs, vb, v_ss, 0, BK, Sk);
  cp_async_commit();

  const int wrow0 = q0 + warp * 16;        // this warp's first query row
  const int row_lo = wrow0 + lane / 4;     // fragment rows: c0,c1 and c2,c3 (+8)
  // up to D = 128 the warp's Q fragments stay in registers; above, they
  // are read from the q tile again for each kv tile (O alone takes D / 2
  // f32 registers a thread: 96 at D = 192)
  constexpr bool kQInRegs = D <= 128;
  uint32_t qf[kQInRegs ? KSTEPS : 1][4];
  float acc[DT][4];
#pragma unroll
  for (int i = 0; i < DT; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;
  float m0 = kNegInf, m1 = kNegInf;  // running max of rows row_lo, row_lo + 8 (log2 units)
  float l0 = 0.f, l1 = 0.f;          // this lane's part of their running sums

  for (int t = 0; t < n_tiles; ++t) {
    const int buf = t & 1;
    if (t + 1 < n_tiles) {
      load_rows(ks + (buf ^ 1) * BK * LD, kb, k_ss, (t + 1) * BK, BK, Sk);
      load_rows(vs + (buf ^ 1) * BK * LD, vb, v_ss, (t + 1) * BK, BK, Sk);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if constexpr (kQInRegs) {
      if (t == 0) {
#pragma unroll
        for (int kk = 0; kk < KSTEPS; ++kk)
          ldmatrix_x4(qf[kk], qs + (warp * 16 + lane % 16) * LD + kk * 16 + (lane / 16) * 8);
      }
    }
    const int k0 = t * BK;
    if (!causal || k0 <= wrow0 + 15) {  // warp-uniform: the tile is not wholly above this warp
      const bf16* kt = ks + buf * BK * LD;
      const bf16* vt = vs + buf * BK * LD;
      float s[NT][4];
#pragma unroll
      for (int i = 0; i < NT; ++i) s[i][0] = s[i][1] = s[i][2] = s[i][3] = 0.f;
#pragma unroll
      for (int kk = 0; kk < KSTEPS; ++kk) {
        const uint32_t* qa = qf[kQInRegs ? kk : 0];
        if constexpr (!kQInRegs)
          ldmatrix_x4(qf[0], qs + (warp * 16 + lane % 16) * LD + kk * 16 + (lane / 16) * 8);
#pragma unroll
        for (int nn = 0; nn < NT; nn += 2) {
          uint32_t bfr[4];  // B fragments of n-tiles nn, nn + 1
          ldmatrix_x4(bfr, kt + (nn * 8 + lane % 8 + (lane / 16) * 8) * LD
                               + kk * 16 + ((lane / 8) % 2) * 8);
          mma_bf16(s[nn], qa, bfr[0], bfr[1]);
          mma_bf16(s[nn + 1], qa, bfr[2], bfr[3]);
        }
      }
      // scale into log2 units; mask keys past Sk and, causal, above the diagonal
      const bool edge = k0 + BK > Sk || (causal && k0 + BK - 1 > wrow0);
      float mx0 = m0, mx1 = m1;
#pragma unroll
      for (int nn = 0; nn < NT; ++nn) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float x = s[nn][e] * scale_log2;
          if (edge) {
            const int col = k0 + nn * 8 + 2 * (lane % 4) + (e & 1);
            const int row = row_lo + (e >> 1) * 8;
            if (col >= Sk || (causal && col > row)) x = kNegInf;
          }
          s[nn][e] = x;
        }
        mx0 = fmaxf(mx0, fmaxf(s[nn][0], s[nn][1]));
        mx1 = fmaxf(mx1, fmaxf(s[nn][2], s[nn][3]));
      }
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
      // key 0 is valid for every row, so from the first tile on mx is finite
      const float a0 = exp2f(m0 - mx0);
      const float a1 = exp2f(m1 - mx1);
      m0 = mx0;
      m1 = mx1;
      l0 *= a0;
      l1 *= a1;
#pragma unroll
      for (int i = 0; i < DT; ++i) {
        acc[i][0] *= a0; acc[i][1] *= a0; acc[i][2] *= a1; acc[i][3] *= a1;
      }
      // P in bf16, laid out as the A operand of P.V (k-step kk = n-tiles 2kk, 2kk+1)
      uint32_t pf[BK / 16][4];
#pragma unroll
      for (int nn = 0; nn < NT; ++nn) {
        const float p0 = exp2f(s[nn][0] - mx0);
        const float p1 = exp2f(s[nn][1] - mx0);
        const float p2 = exp2f(s[nn][2] - mx1);
        const float p3 = exp2f(s[nn][3] - mx1);
        l0 += p0 + p1;
        l1 += p2 + p3;
        pf[nn / 2][(nn % 2) * 2 + 0] = pack_bf16(p0, p1);
        pf[nn / 2][(nn % 2) * 2 + 1] = pack_bf16(p2, p3);
      }
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
#pragma unroll
        for (int dt = 0; dt < DT; dt += 2) {
          uint32_t bfr[4];  // B fragments of d-tiles dt, dt + 1
          ldmatrix_x4_trans(bfr, vt + (kk * 16 + lane % 16) * LD + dt * 8 + (lane / 16) * 8);
          mma_bf16(acc[dt], pf[kk], bfr[0], bfr[1]);
          mma_bf16(acc[dt + 1], pf[kk], bfr[2], bfr[3]);
        }
      }
    }
    __syncthreads();  // buffer buf is refilled by the next iteration's loads
  }

  l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
  l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
  const float inv0 = 1.f / fmaxf(l0, 1e-30f);
  const float inv1 = 1.f / fmaxf(l1, 1e-30f);
  // stage the warp's 16 rows in its own rows of the q tile (read only by
  // this warp, at t == 0), then 16-byte stores
  bf16* ow = qs + warp * 16 * LD;
#pragma unroll
  for (int dt = 0; dt < DT; ++dt) {
    const int col = dt * 8 + 2 * (lane % 4);
    *reinterpret_cast<uint32_t*>(ow + (lane / 4) * LD + col) =
        pack_bf16(acc[dt][0] * inv0, acc[dt][1] * inv0);
    *reinterpret_cast<uint32_t*>(ow + (lane / 4 + 8) * LD + col) =
        pack_bf16(acc[dt][2] * inv1, acc[dt][3] * inv1);
  }
  __syncwarp();
  bf16* ob = o + b * o_sb + h * o_sh;
  for (int idx = lane; idx < 16 * CH; idx += 32) {
    const int r = idx / CH;
    const int c = idx - r * CH;
    const int pos = wrow0 + r;
    if (pos < Sq)
      *reinterpret_cast<uint4*>(ob + pos * o_ss + c * 8) =
          *reinterpret_cast<const uint4*>(ow + r * LD + c * 8);
  }
}

// ----------------------------------------------------------------- launch
struct Args {
  const void* q; const void* k; const void* v; void* o;
  int B, Sq, Sk, Hq, Hkv, causal;
  long long qs[3], ks[3], vs[3], os[3];
  cudaStream_t stream;
};

template <int D>
int launch_f32(const Args& a) {
  // the f32 kv tile in static shared memory: at most 32 KB (D = 64, 128),
  // 28 KB at D = 112, 24 KB at D = 192 (16 rows: 32 would fill all 48 KB)
  constexpr int BK = D <= 64 ? 64 : (D <= 128 ? 32 : 16);
  dim3 grid((a.Sq + kBlockQ - 1) / kBlockQ, a.B * a.Hq);
  flash_fwd_kernel<float, D, BK><<<grid, kThreads, 0, a.stream>>>(
      static_cast<const float*>(a.q), static_cast<const float*>(a.k),
      static_cast<const float*>(a.v), static_cast<float*>(a.o), a.Sq, a.Sk, a.Hq,
      a.Hq / a.Hkv,
      a.qs[0], a.qs[1], a.qs[2], a.ks[0], a.ks[1], a.ks[2], a.vs[0], a.vs[1], a.vs[2],
      a.os[0], a.os[1], a.os[2], 1.0f / sqrtf(static_cast<float>(D)), a.causal);
  return 0;
}

template <int D>
int launch_bf16(const Args& a, int device) {
  constexpr int smem = mma_smem_bytes<D>();
  if (smem > 48 * 1024) {  // above 48 KB only by opting in, once per device
    static bool opted[64] = {};
    if (device < 0 || device >= 64) return -1;
    if (!opted[device]) {
      cudaError_t err = cudaFuncSetAttribute(flash_mma_kernel<D>,
                                             cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
      if (err != cudaSuccess) return static_cast<int>(err);
      opted[device] = true;
    }
  }
  constexpr int BQ = 16 * kMmaWarps;
  dim3 grid((a.Sq + BQ - 1) / BQ, a.B * a.Hq);
  const float scale_log2 = 1.4426950408889634f / sqrtf(static_cast<float>(D));
  flash_mma_kernel<D><<<grid, kMmaWarps * 32, smem, a.stream>>>(
      static_cast<const bf16*>(a.q), static_cast<const bf16*>(a.k),
      static_cast<const bf16*>(a.v), static_cast<bf16*>(a.o), a.Sq, a.Sk, a.Hq,
      a.Hq / a.Hkv,
      a.qs[0], a.qs[1], a.qs[2], a.ks[0], a.ks[1], a.ks[2], a.vs[0], a.vs[1], a.vs[2],
      a.os[0], a.os[1], a.os[2], scale_log2, a.causal);
  return 0;
}

}  // namespace

extern "C" {

// Returns 0 on success, a negative code for arguments the kernel does not
// take (-1 bad head counts or sizes, -2 head dim, -3 dtype), else the
// cudaError_t of the launch.
int flash_attention_fwd(const void* q, const void* k, const void* v, void* o,
                        int dtype, int B, int Sq, int Sk, int Hq, int Hkv, int D,
                        int causal, long long q_sb, long long q_ss,
                        long long q_sh, long long k_sb, long long k_ss,
                        long long k_sh, long long v_sb, long long v_ss,
                        long long v_sh, long long o_sb, long long o_ss,
                        long long o_sh, int device, void* stream) {
  if (B <= 0 || Sq <= 0 || Sk <= 0 || Hkv <= 0 || Hq % Hkv != 0 || B * Hq > 65535) return -1;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const Args a{q, k, v, o, B, Sq, Sk, Hq, Hkv, causal,
               {q_sb, q_ss, q_sh}, {k_sb, k_ss, k_sh}, {v_sb, v_ss, v_sh},
               {o_sb, o_ss, o_sh}, static_cast<cudaStream_t>(stream)};
  int rc;
  if (dtype == 0) {
    switch (D) {
      case 16: rc = launch_f32<16>(a); break;
      case 32: rc = launch_f32<32>(a); break;
      case 64: rc = launch_f32<64>(a); break;
      case 112: rc = launch_f32<112>(a); break;
      case 128: rc = launch_f32<128>(a); break;
      case 192: rc = launch_f32<192>(a); break;
      default: return -2;
    }
  } else if (dtype == 1) {
    switch (D) {
      case 16: rc = launch_bf16<16>(a, device); break;
      case 32: rc = launch_bf16<32>(a, device); break;
      case 64: rc = launch_bf16<64>(a, device); break;
      case 112: rc = launch_bf16<112>(a, device); break;
      case 128: rc = launch_bf16<128>(a, device); break;
      case 192: rc = launch_bf16<192>(a, device); break;
      default: return -2;
    }
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
