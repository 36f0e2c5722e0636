// Decode attention for Hopper, sm_90a: one query token per sequence
// against the KV cache. Plain C interface, loaded with ctypes by
// repro_torch/kernels/decode_attention.py.
//
// Replaces the TPU kernel src/repro/kernels/decode_attention.py::
// decode_attention_bhgd (_decode_kernel): for each (batch, kv head) the G
// query heads that share the kv head go against that head's cache rows
// [0, len) with an online softmax in f32; rows past the length are masked
// (-1e30) and skipped; the row sum is clamped at 1e-30, so a length of 0
// gives zeros, as the TPU kernel does.
//
// Layout: q (B, 1, Hq, D) and the cache of one layer (B, S_max, Hkv, D),
// each through its own element strides (last dim contiguous, rows 16-byte
// aligned): the cache is read where the model keeps it, with no per-step
// transpose or copy. The lengths are int32 on the device (len_stride 0
// broadcasts one length to the batch), so the host never waits on them.
//
// Bound on the H100 (3.35 TB/s): the work is 4·G·D flops per cached row
// against 4·D bytes of bf16 k+v, so bytes bound at any G. At qwen2-0.5b's
// serving shape B=32, S_max=144, Hkv=2, D=64 the valid cache is at most
// ~2.4 MB, ~0.7 us, below one launch's latency (~5 us measured with CUDA
// events); at Zamba2's shared block (Hkv = 32, G = 1) ~37.7 MB, ~11.3 us.
//
// Design: one block of 4 warps per (split of the cache rows, batch, kv
// head, chunk of at most 2 q heads of its group), so a block at G = 1 has
// 4 warps, and qwen2's G = 7 runs 4 chunks (measured on the H100 with
// chip_smoke.py: chunks of 2 beat chunks of 4 and of 8 at buckets 1 and
// 32 — fewer heads a lane shorten each row's chain of dot products and
// updates, which bounds this latency-bound kernel, and the chunks re-read
// a row from L2). A cache row is read by D·size/16 lanes with one 16-byte
// load each (8 lanes for bf16 D=64: a warp reads 4 rows at once), straight
// into registers, 4 rows in flight a lane; the lanes finish each row's dot
// products for the chunk's q heads (held in registers, prescaled to log2
// units, so exp2f does the softmax) with log2(lanes a row) xor-shuffles.
// Each group of lanes keeps its own running max, sum and accumulator per
// head; they merge by shuffles inside a warp and through shared memory
// across warps. The shuffles need a power of two of lanes a row: where the
// row's 16-byte chunks are not one (bf16 D = 112, 192 and 224: 14, 24 and
// 28; f32 D = 112: 28) a row gets the next power of two of lanes and the
// lanes past its last chunk load nothing and add zeros (bf16 D = 112
// leaves 2 of 16 lanes idle, 192 8 of 32, 224 4 of 32); where a row has
// more chunks than a warp has lanes (f32 D = 192 and 224: 48 and 56) a
// lane takes two chunks, 32 apart.
//
// Split S (flash-decoding): the launcher sets the split count from
// (B, Hkv, S_max) alone, never from the length (it lives on the device),
// to fill the SMs where B·Hkv blocks would not. The splits of a (batch, kv
// head, chunk) run as one thread-block cluster (at most 8 blocks, launched
// with cudaLaunchKernelEx): each block leaves its (m, l, accumulator) in
// its shared memory and block 0 merges them through distributed shared
// memory (rescale by exp2(m_i - m), sum, divide by the clamped l), so there
// is no scratch in device memory, no atomic and no second kernel. A split
// that starts at or past its row's length reads nothing and contributes
// m = -1e30, l = 0. Measured on the H100: at S_max = 144 one split is the
// fastest at every bucket, so the serving shapes run one; at S_max = 4096
// and B = 1 eight splits take under a third of one split's time.
// Tensor cores do not help at G <= 8: the work is bytes.
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr float kNegInf = -1e30f;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kWarps = 4;
constexpr int kRowsInFlight = 4;  // cache rows a lane loads before it computes
constexpr int kMaxChunk = 2;  // q heads a block holds in registers
constexpr int kMaxSplits = 8;  // blocks of a portable thread-block cluster
constexpr float kLog2e = 1.4426950408889634f;

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// 16 bytes of T as floats
__device__ __forceinline__ void unpack(const uint4& r, float (&x)[4], float) {
  x[0] = __uint_as_float(r.x); x[1] = __uint_as_float(r.y);
  x[2] = __uint_as_float(r.z); x[3] = __uint_as_float(r.w);
}
__device__ __forceinline__ void unpack(const uint4& r, float (&x)[8], __nv_bfloat16) {
  const uint32_t w[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w[i]));
    x[2 * i] = f.x;
    x[2 * i + 1] = f.y;
  }
}

__device__ __forceinline__ uint4 load16(const void* p) {
  return __ldg(reinterpret_cast<const uint4*>(p));
}

// m, l, acc of a partial softmax absorb another one (all may be empty:
// m = -1e30, l = 0, acc = 0); m in log2 units
template <int C, int V>
__device__ __forceinline__ void absorb(float& m, float& l, float (&acc)[C][V],
                                       float mo, float lo, const float (&acco)[C][V]) {
  const float mn = fmaxf(m, mo);
  const float a = exp2f(m - mn);
  const float bo = exp2f(mo - mn);
  l = l * a + lo * bo;
#pragma unroll
  for (int j = 0; j < C; ++j)
#pragma unroll
    for (int e = 0; e < V; ++e) acc[j][e] = acc[j][e] * a + acco[j][e] * bo;
  m = mn;
}

__host__ __device__ constexpr int next_pow2(int n) {
  int p = 1;
  while (p < n) p *= 2;
  return p;
}

template <typename T, int D, int GC>
__global__ void __launch_bounds__(kWarps * 32)
decode_split_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const int* __restrict__ lengths,
                    int len_stride, T* __restrict__ o, int S_max, int Hkv, int group,
                    int n_chunks, int n_splits, int split_len,
                    int64_t q_sb, int64_t q_sh,
                    int64_t k_sb, int64_t k_ss, int64_t k_sh,
                    int64_t v_sb, int64_t v_ss, int64_t v_sh,
                    int64_t o_sb, int64_t o_sh, float scale_log2) {
  constexpr int U = kRowsInFlight;
  constexpr int VEC = 16 / sizeof(T);   // elements of one 16-byte load
  static_assert(D % VEC == 0, "a row is whole 16-byte chunks");
  constexpr int DC = D / VEC;           // 16-byte chunks of a row
  constexpr int CPL = (DC + 31) / 32;   // chunks a lane: 2 for f32 at D = 192
  // lanes a row, a power of two for the xor-shuffle reductions; where DC is
  // not (D = 112 and 192) the lanes past the row's last chunk load nothing
  // and add zeros
  constexpr int LPR = next_pow2((DC + CPL - 1) / CPL);
  constexpr int RPW = 32 / LPR;         // rows a warp reads at once
  constexpr int NS = kWarps * RPW;      // lane groups ("streams") a block
  __shared__ float sm_acc[kWarps][GC][D];
  __shared__ float sm_m[kWarps][GC];
  __shared__ float sm_l[kWarps][GC];

  const int split = blockIdx.x;
  const int chunk = blockIdx.y % n_chunks;
  const int bh = blockIdx.y / n_chunks;
  const int b = bh / Hkv;
  const int hkv = bh - b * Hkv;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int sub = lane % LPR;           // this lane's chunks of a row: sub + LPR * j
  const int sw = lane / LPR;            // this lane's stream in the warp
  const int g0 = chunk * GC;            // first head of the chunk in the group
  bool has[CPL];                        // chunk j of this lane lies in the row
#pragma unroll
  for (int j = 0; j < CPL; ++j) has[j] = sub + LPR * j < DC;

  int len = lengths[b * len_stride];
  len = min(max(len, 0), S_max);
  const int s0 = split * split_len;
  const int s1 = min(s0 + split_len, len);

  float qr[GC][CPL][VEC];
#pragma unroll
  for (int gi = 0; gi < GC; ++gi) {
#pragma unroll
    for (int j = 0; j < CPL; ++j) {
      if (g0 + gi < group && has[j]) {
        const T* qp = q + b * q_sb + (hkv * group + g0 + gi) * q_sh + (sub + LPR * j) * VEC;
        unpack(load16(qp), qr[gi][j], T());
#pragma unroll
        for (int e = 0; e < VEC; ++e) qr[gi][j][e] *= scale_log2;  // scores in log2 units
      } else {
#pragma unroll
        for (int e = 0; e < VEC; ++e) qr[gi][j][e] = 0.f;
      }
    }
  }
  float m[GC], l[GC], acc[GC][CPL][VEC];
#pragma unroll
  for (int gi = 0; gi < GC; ++gi) {
    m[gi] = kNegInf;
    l[gi] = 0.f;
#pragma unroll
    for (int j = 0; j < CPL; ++j)
#pragma unroll
      for (int e = 0; e < VEC; ++e) acc[gi][j][e] = 0.f;
  }

  const T* kb = k + b * k_sb + hkv * k_sh + sub * VEC;
  const T* vb = v + b * v_sb + hkv * v_sh + sub * VEC;
  // warp-uniform loop (the shuffles need every lane): this pass covers rows
  // base + u·NS + sw, u < U
  for (int base = s0 + warp * RPW; base < s1; base += NS * U) {
    uint4 kr[U][CPL], vr[U][CPL];
    bool ok[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int row = base + u * NS + sw;
      ok[u] = row < s1;
#pragma unroll
      for (int j = 0; j < CPL; ++j) {
        kr[u][j] = vr[u][j] = make_uint4(0u, 0u, 0u, 0u);
        if (ok[u] && has[j]) {
          kr[u][j] = load16(kb + row * k_ss + LPR * j * VEC);
          vr[u][j] = load16(vb + row * v_ss + LPR * j * VEC);
        }
      }
    }
    float s[U][GC];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      float kf[CPL][VEC];
#pragma unroll
      for (int j = 0; j < CPL; ++j) unpack(kr[u][j], kf[j], T());
#pragma unroll
      for (int gi = 0; gi < GC; ++gi) {
        float dot = 0.f;
#pragma unroll
        for (int j = 0; j < CPL; ++j)
#pragma unroll
          for (int e = 0; e < VEC; ++e) dot = fmaf(qr[gi][j][e], kf[j][e], dot);
#pragma unroll
        for (int off = LPR / 2; off > 0; off >>= 1) dot += __shfl_xor_sync(kFull, dot, off);
        s[u][gi] = ok[u] ? dot : kNegInf;
      }
    }
#pragma unroll
    for (int gi = 0; gi < GC; ++gi) {
      float mx = m[gi];
#pragma unroll
      for (int u = 0; u < U; ++u) mx = fmaxf(mx, s[u][gi]);
      const float alpha = exp2f(m[gi] - mx);
      l[gi] *= alpha;
#pragma unroll
      for (int j = 0; j < CPL; ++j)
#pragma unroll
        for (int e = 0; e < VEC; ++e) acc[gi][j][e] *= alpha;
      m[gi] = mx;
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if (!ok[u]) continue;
      float vf[CPL][VEC];
#pragma unroll
      for (int j = 0; j < CPL; ++j) unpack(vr[u][j], vf[j], T());
#pragma unroll
      for (int gi = 0; gi < GC; ++gi) {
        const float p = exp2f(s[u][gi] - m[gi]);
        l[gi] += p;
#pragma unroll
        for (int j = 0; j < CPL; ++j)
#pragma unroll
          for (int e = 0; e < VEC; ++e) acc[gi][j][e] = fmaf(p, vf[j][e], acc[gi][j][e]);
      }
    }
  }

  // merge the warp's streams (lanes with the same `sub` hold the same dims)
#pragma unroll
  for (int off = LPR; off < 32; off <<= 1) {
#pragma unroll
    for (int gi = 0; gi < GC; ++gi) {
      const float mo = __shfl_xor_sync(kFull, m[gi], off);
      const float lo = __shfl_xor_sync(kFull, l[gi], off);
      float acco[CPL][VEC];
#pragma unroll
      for (int j = 0; j < CPL; ++j)
#pragma unroll
        for (int e = 0; e < VEC; ++e) acco[j][e] = __shfl_xor_sync(kFull, acc[gi][j][e], off);
      absorb(m[gi], l[gi], acc[gi], mo, lo, acco);
    }
  }
  if (sw == 0) {
#pragma unroll
    for (int gi = 0; gi < GC; ++gi) {
#pragma unroll
      for (int j = 0; j < CPL; ++j) {
        if (!has[j]) continue;
#pragma unroll
        for (int e = 0; e < VEC; ++e)
          sm_acc[warp][gi][(sub + LPR * j) * VEC + e] = acc[gi][j][e];
      }
      if (sub == 0) {
        sm_m[warp][gi] = m[gi];
        sm_l[warp][gi] = l[gi];
      }
    }
  }
  __syncthreads();

  // merge the warps: one thread per (head of the chunk, dim)
  __shared__ float sm_res[GC][D + 2];  // this block's (accumulator, m, l) a head
  for (int idx = tid; idx < GC * D; idx += kWarps * 32) {
    const int gi = idx / D;
    const int d = idx - gi * D;
    if (g0 + gi >= group) continue;
    float mt = kNegInf;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) mt = fmaxf(mt, sm_m[w][gi]);
    float lt = 0.f, at = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float wt = exp2f(sm_m[w][gi] - mt);
      lt = fmaf(sm_l[w][gi], wt, lt);
      at = fmaf(sm_acc[w][gi][d], wt, at);
    }
    if (n_splits == 1) {
      o[b * o_sb + (hkv * group + g0 + gi) * o_sh + d] = from_f32<T>(at / fmaxf(lt, 1e-30f));
    } else {
      sm_res[gi][d] = at;
      if (d == 0) {
        sm_res[gi][D] = mt;
        sm_res[gi][D + 1] = lt;
      }
    }
  }
  if (n_splits == 1) return;

  // the splits of this (batch, kv head, chunk) form one thread-block
  // cluster: block 0 reads the others' results from their shared memory
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();
  if (cluster.block_rank() == 0) {
    for (int idx = tid; idx < GC * D; idx += kWarps * 32) {
      const int gi = idx / D;
      const int d = idx - gi * D;
      if (g0 + gi >= group) continue;
      float mt = kNegInf;
      for (int r = 0; r < n_splits; ++r)
        mt = fmaxf(mt, cluster.map_shared_rank(&sm_res[gi][0], r)[D]);
      float lt = 0.f, at = 0.f;
      for (int r = 0; r < n_splits; ++r) {
        const float* rr = cluster.map_shared_rank(&sm_res[gi][0], r);
        const float wt = exp2f(rr[D] - mt);
        lt = fmaf(rr[D + 1], wt, lt);
        at = fmaf(rr[d], wt, at);
      }
      o[b * o_sb + (hkv * group + g0 + gi) * o_sh + d] = from_f32<T>(at / fmaxf(lt, 1e-30f));
    }
  }
  cluster.sync();  // every block's shared memory lives until block 0 has read it
}

struct Args {
  const void* q; const void* k; const void* v; const int* lengths; int len_stride;
  void* o;
  int B, S_max, Hq, Hkv, n_splits, split_len;
  long long qs[2], ks[3], vs[3], os[2];
  cudaStream_t stream;
};

template <typename T, int D, int GC>
int launch(const Args& a) {
  const int group = a.Hq / a.Hkv;
  const int n_chunks = (group + GC - 1) / GC;
  if (a.B * a.Hkv * n_chunks > 65535) return -1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(a.n_splits, a.B * a.Hkv * n_chunks);
  cfg.blockDim = dim3(kWarps * 32);
  cfg.stream = a.stream;
  cudaLaunchAttribute cluster[1];
  cluster[0].id = cudaLaunchAttributeClusterDimension;
  cluster[0].val.clusterDim.x = a.n_splits;  // the splits of a (batch, kv head, chunk)
  cluster[0].val.clusterDim.y = 1;
  cluster[0].val.clusterDim.z = 1;
  cfg.attrs = cluster;
  cfg.numAttrs = a.n_splits > 1 ? 1 : 0;
  return static_cast<int>(cudaLaunchKernelEx(
      &cfg, decode_split_kernel<T, D, GC>, static_cast<const T*>(a.q),
      static_cast<const T*>(a.k), static_cast<const T*>(a.v), a.lengths, a.len_stride,
      static_cast<T*>(a.o), a.S_max, a.Hkv, group, n_chunks, a.n_splits, a.split_len,
      static_cast<int64_t>(a.qs[0]), static_cast<int64_t>(a.qs[1]),
      static_cast<int64_t>(a.ks[0]), static_cast<int64_t>(a.ks[1]),
      static_cast<int64_t>(a.ks[2]), static_cast<int64_t>(a.vs[0]),
      static_cast<int64_t>(a.vs[1]), static_cast<int64_t>(a.vs[2]),
      static_cast<int64_t>(a.os[0]), static_cast<int64_t>(a.os[1]),
      kLog2e / sqrtf(static_cast<float>(D))));
}

template <typename T, int D>
int dispatch_group(const Args& a) {
  const int group = a.Hq / a.Hkv;
  if (group <= 1) return launch<T, D, 1>(a);
  return launch<T, D, kMaxChunk>(a);
}

template <typename T>
int dispatch_d(int D, const Args& a) {
  switch (D) {
    case 16: return dispatch_group<T, 16>(a);
    case 32: return dispatch_group<T, 32>(a);
    case 64: return dispatch_group<T, 64>(a);
    case 112: return dispatch_group<T, 112>(a);
    case 128: return dispatch_group<T, 128>(a);
    case 192: return dispatch_group<T, 192>(a);
    case 224: return dispatch_group<T, 224>(a);
    default: return -2;
  }
}

}  // namespace

extern "C" {

// Returns 0 on success, a negative code for arguments the kernel does not
// take (-1 bad head counts, sizes or splits, -2 head dim, -3 dtype), else
// the cudaError_t of the launch. Split i covers cache rows
// [i * split_len, (i + 1) * split_len); at most kMaxSplits splits.
int decode_attention_fwd(const void* q, const void* k, const void* v,
                         const void* lengths, int len_stride, void* o,
                         int dtype, int B, int S_max, int Hq, int Hkv, int D,
                         int n_splits, int split_len,
                         long long q_sb, long long q_sh, long long k_sb,
                         long long k_ss, long long k_sh, long long v_sb,
                         long long v_ss, long long v_sh, long long o_sb,
                         long long o_sh, int device, void* stream) {
  if (B <= 0 || S_max <= 0 || Hkv <= 0 || Hq % Hkv != 0 || Hq / Hkv > 32) return -1;
  if (n_splits < 1 || n_splits > kMaxSplits || split_len < 1 ||
      static_cast<long long>(n_splits) * split_len < S_max)
    return -1;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const Args a{q, k, v, static_cast<const int*>(lengths), len_stride, o,
               B, S_max, Hq, Hkv, n_splits, split_len,
               {q_sb, q_sh}, {k_sb, k_ss, k_sh}, {v_sb, v_ss, v_sh}, {o_sb, o_sh},
               static_cast<cudaStream_t>(stream)};
  int rc;
  if (dtype == 0) {
    rc = dispatch_d<float>(D, a);
  } else if (dtype == 1) {
    rc = dispatch_d<__nv_bfloat16>(D, a);
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
