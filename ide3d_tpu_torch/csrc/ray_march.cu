// K1: depth sort + alpha compositing of the merged coarse+fine ray samples.
//
// Replaces the TPU kernel `sort_integrate_pallas` / `_kernel` in
// ide3d_tpu/ops/pallas/ray_march.py, and carries the options of the fine
// composite `integrate_rays_merged` (ide3d_tpu/render/integration.py). Per ray
// of S = Sa + Sb samples (the coarse half a, the fine half b):
//   * a stable depth sort (ties by index, the first half before the second);
//   * delta_k = (z_{k+1} - z_k) * |ray_d| in depth order, 1e10 * |ray_d| last;
//   * density = clamp(sigma + noise), softplus or relu; x_k = delta_k * density;
//     alpha_k = 1 - exp(-x_k);
//   * the exclusive transmittance exp(sum_{j<k} -x_j) from the analytic
//     log(1 - alpha) = -x, as a shifted inclusive scan: no lane subtracts its
//     own term, so the 1e10 last term never enters a transmittance;
//   * w = alpha * T; weights_sum = sum w and depth = sum w*z, both summed in
//     DEPTH order; last_back adds 1 - sum w to the depth-order last weight
//     before the feature and depth sums (weights_sum is then the adjusted sum);
//   * feat = sum w * vals[:, :C] in INPUT order; white_back adds 1 - sum w,
//     the sum before any last_back adjustment.
// Everything is computed in fp32; `vals` may be fp32 or bf16.
//
// Bound on the H100: bytes. At the frame's shape (R = 4096 rays per image,
// S = 96 + 96, C + 1 = 52, bf16 vals) a ray moves 19,968 B of values, 768 B
// of depths, 4 B of |ray_d| and 212 B of outputs: 85.8 MB per image, 25.6 us
// at 3.35 TB/s (76.9 us for the frame's batch of 3). The arithmetic is ~10k
// FMAs per ray, far below the byte time.
//
// Design, against what held the first (one 256-thread block per ray) version
// back:
//   1. The loads are asynchronous and issued first. A ray's depths, noise and
//      both value slabs go to a shared-memory stage by TMA bulk copies
//      (cp.async.bulk + mbarrier, issued by one thread); the values are never
//      read from HBM twice, and sigma comes from the staged slab. The grid is
//      persistent: a block walks over rays (blockIdx.x, + gridDim.x, ...) and
//      issues the next ray's copies as soon as it has finished reading the
//      stage (a proxy fence by every thread, then a barrier). The copies of
//      the SM's other blocks are in flight while one block ranks, scans and
//      sums.
//   2. Several rays per SM. A block is 4 warps with one stage of ~21 KB at the
//      frame's shape, so 9 blocks (9 rays, 36 warps) are resident per SM; the
//      registers are budgeted for that (kMinBlocks). Measured on the H100,
//      more resident rays beat a deeper ring: two stages a block (5 blocks)
//      and 8 warps a block were slower, one stage of 4 warps the fastest
//      (PERF.md). The sorted depths reuse the stage's depth area and the
//      channel partials its value area, to keep a block small.
//   3. Wide loads. The channel sums read the slab as 16-byte vectors. A "unit"
//      of unit_rows rows is a whole number unit_vecs of vectors (two rows of
//      52 bf16 = 13 vectors); lane j of a group reads vector j of each unit its
//      group takes, so each of the vector's 8 (bf16) or 4 (fp32) values keeps a
//      fixed channel. The per-thread sums fold by shuffles within a warp, then
//      across the warps per channel, in a fixed order.
//   Ranking: a vote checks whether each half arrives sorted, as it does in the
//   deterministic render (linspace coarse depths, sample_pdf(det) fine
//   depths). A sorted half ranks its own samples by index and is binary-
//   searched by the other half's samples; an unsorted half is counted by
//   comparison over float4 reads of its depths. Both give the stable order
//   with the same tie rule.
// Shapes the stage does not take (a half whose bytes are not a multiple of 16,
// a pointer not 16-byte aligned, or a ray above 64 KB, e.g. 256 x 256 fp32)
// run "streamed": depths and sigma read directly, the values copied in row
// chunks into the stage by the block and summed one channel per thread.
//
// C interface (loaded with ctypes): returns cudaGetLastError() after the
// launch, 0 on success. The kernel launches on the given stream, does not
// synchronise and allocates nothing. The launch plan (stage layout and mode)
// is made here from the shapes and the pointers' alignment (make_plan).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

namespace {

constexpr int kMaxSamples = 256;              // S <= 256, C + 1 <= 256
constexpr int kWarps = 4;                     // a block: one ray at a time
constexpr int kMinBlocks = 9;                 // blocks per SM the registers are budgeted for
constexpr int kThreads = 32 * kWarps;
constexpr int kItems = kMaxSamples / kThreads;  // samples per thread
constexpr int kChans = kMaxSamples / kThreads;  // channels per thread (scalar sums)
constexpr int kRedFloats = 4 * kWarps;        // per-warp scan totals and sums
constexpr int kHeaderBytes = 128;             // the mbarrier; a 128-aligned stage copies faster
constexpr int kMaxStageBytes = 64 * 1024;     // a ray above this is streamed
constexpr int kStreamChunkBytes = 16 * 1024;  // rows of values per chunk when streamed
constexpr float kLastDelta = 1e10f;
constexpr unsigned kFull = 0xffffffffu;

// Launch plan. A stage holds a ray's depths (z_b at a 16-byte offset), its
// noise, then its values. "staged": the whole ray fits the stage and every
// piece is a multiple of 16 bytes at a 16-byte-aligned address, so TMA bulk
// copies fill it; otherwise the ray is streamed through it in row chunks.
// "vec": the channel sums read 16-byte vectors; a unit of unit_rows rows is
// unit_vecs vectors, and a vector spans at most two rows (a row is >= 16 B).
struct Plan {
  int staged;       // 1: TMA-filled; 0: streamed
  int vec;          // 1: channel sums from 16-byte vectors
  int unit_rows;    // rows per unit (vec)
  int unit_vecs;    // 16-byte vectors per unit (vec), <= 32
  int zb_off;       // floats: z_b's offset in the stage
  int noise_off;    // floats: the noise's offset in the stage
  int vals_off;     // bytes: the values' offset in the stage
  int chunk_rows;   // rows of values the stage holds
  int stride;       // bytes of the stage; the vector sums' partials overlay its values
};

int round_up(int n, int m) { return (n + m - 1) / m * m; }

Plan make_plan(int s_a, int s_b, int channels, int esize, bool noise, bool aligned) {
  const int S = s_a + s_b, rb = channels * esize;
  Plan p;
  p.zb_off = round_up(s_a, 4);
  p.noise_off = p.zb_off + round_up(s_b, 4);
  p.vals_off = 4 * (p.noise_off + (noise ? round_up(S, 4) : 0));
  int g = 16;  // gcd(rb, 16)
  while (rb % g) g >>= 1;
  p.unit_rows = 16 / g;
  p.unit_vecs = p.unit_rows * rb / 16;
  p.vec = p.unit_vecs <= 32 && rb >= 16;
  p.staged = aligned && s_a % 4 == 0 && s_b % 4 == 0 && (s_a * rb) % 16 == 0 &&
             (s_b * rb) % 16 == 0 && p.vals_off + S * rb <= kMaxStageBytes;
  int bytes;
  if (p.staged) {
    p.chunk_rows = S;
    const int partials = p.vec ? 4 * kWarps * p.unit_rows * channels : 0;
    bytes = p.vals_off + (S * rb > partials ? S * rb : partials);
  } else {
    p.vec = 0;
    p.chunk_rows = kStreamChunkBytes / rb < S ? kStreamChunkBytes / rb : S;
    bytes = p.vals_off + p.chunk_rows * rb;
  }
  p.stride = round_up(bytes, 128);
  return p;
}

// Shared memory of a block: the mbarrier; the stage (depths, noise, values;
// the sorted depths overlay its depths once ranked, the vector sums'
// per-warp partials its values once summed); the per-warp sums; the density,
// then weight, of each input sample (S + 1: the vector sums may read one
// past); the input index of each sorted position (S bytes).
int smem_bytes(const Plan& p, int S) {
  return kHeaderBytes + p.stride + 4 * kRedFloats + 4 * (S + 1) + S;
}

template <typename T>
struct Args {
  const float* z_a;
  const T* v_a;
  int s_a;
  const float* z_b;
  const T* v_b;
  int s_b;
  const float* ray_norm;
  const float* noise;  // [n_rays, S] or null
  int n_rays, channels, last_back, white_back;
  Plan plan;
  float* feat;
  float* depth;
  float* wsum;
};

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <bool kRelu>
__device__ __forceinline__ float clamp_density(float s) {
  if (kRelu) return fmaxf(s, 0.f);
  return fmaxf(s, 0.f) + log1pf(expf(-fabsf(s)));  // softplus, overflow-safe
}

// 16 bytes of values -> fp32.
__device__ __forceinline__ void unpack(const uint4 r, float (&v)[8]) {  // 8 bf16
  const uint32_t w[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    v[2 * q] = __uint_as_float(w[q] << 16);
    v[2 * q + 1] = __uint_as_float(w[q] & 0xffff0000u);
  }
}
__device__ __forceinline__ void unpack(const uint4 r, float (&v)[4]) {  // 4 fp32
  v[0] = __uint_as_float(r.x);
  v[1] = __uint_as_float(r.y);
  v[2] = __uint_as_float(r.z);
  v[3] = __uint_as_float(r.w);
}

__device__ __forceinline__ float warp_allsum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

// Exclusive prefix sum over the warp's lanes, by shifting the inclusive scan.
__device__ __forceinline__ float warp_exclusive_scan(float v) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const float n = __shfl_up_sync(kFull, v, o);
    if (lane >= o) v += n;
  }
  const float e = __shfl_up_sync(kFull, v, 1);
  return lane == 0 ? 0.f : e;
}

// ---------------------------------------------------------------- TMA, mbarrier

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(smem_addr(bar)) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

// Spins until the phase of the given parity completes; traps (a launch
// failure the wrapper reports) if it has not after ~10 s of clock cycles.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const long long start = clock64();
  uint32_t done = 0;
  do {
    if (clock64() - start > 20000000000LL) __trap();
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
  } while (!done);
}

// Global -> shared bulk copy; dst, src and bytes are multiples of 16.
__device__ __forceinline__ void bulk_load(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];" ::
          "r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// Thread 0: fill `stage` with ray `ray`'s depths, noise and values.
template <typename T>
__device__ void issue_ray(const Args<T>& a, int ray, unsigned char* stage, uint64_t* bar) {
  const Plan& pl = a.plan;
  const int s_a = a.s_a, s_b = a.s_b, S = s_a + s_b;
  const uint32_t rb = a.channels * sizeof(T);
  float* z = reinterpret_cast<float*>(stage);
  unsigned char* v = stage + pl.vals_off;
  mbar_expect_tx(bar, S * 4u + S * rb + (a.noise ? S * 4u : 0u));
  bulk_load(z, a.z_a + static_cast<size_t>(ray) * s_a, s_a * 4u, bar);
  bulk_load(z + pl.zb_off, a.z_b + static_cast<size_t>(ray) * s_b, s_b * 4u, bar);
  if (a.noise) bulk_load(z + pl.noise_off, a.noise + static_cast<size_t>(ray) * S, S * 4u, bar);
  bulk_load(v, a.v_a + static_cast<size_t>(ray) * s_a * a.channels, s_a * rb, bar);
  bulk_load(v + s_a * rb, a.v_b + static_cast<size_t>(ray) * s_b * a.channels, s_b * rb, bar);
}


// ---------------------------------------------------------------- ranking

__device__ __forceinline__ int before(float zj, int j, float z, int thr) {
  return (zj < z) | ((zj == z) & (j < thr));
}

// Adds to rank[k] the number of samples of one half (depths zh[0..n), the
// half's first sample at merged index `first`) that precede item k in the
// stable order, by comparison: z_j < z, or z_j == z and j < thr, where thr is
// the item's index in the half if it belongs to it, else INT_MAX for the
// first half (ties go to it) and 0 for the second.
__device__ __forceinline__ void count_half(const float* zh, int n, int first, bool is_a, int S,
                                           const float (&zi)[kItems], int (&rank)[kItems]) {
  const int t = threadIdx.x;
  int thr[kItems], cnt[kItems];
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    const int h = k * kThreads + t - first;
    thr[k] = (h >= 0 && h < n) ? h : (is_a ? INT_MAX : 0);
    cnt[k] = 0;
  }
  const float4* zh4 = reinterpret_cast<const float4*>(zh);  // 16-byte aligned
  const int n4 = n >> 2;
#pragma unroll 2
  for (int q = 0; q < n4; ++q) {
    const float4 z4 = zh4[q];
    const int j = 4 * q;
#pragma unroll
    for (int k = 0; k < kItems; ++k) {
      cnt[k] += before(z4.x, j, zi[k], thr[k]) + before(z4.y, j + 1, zi[k], thr[k]) +
                before(z4.z, j + 2, zi[k], thr[k]) + before(z4.w, j + 3, zi[k], thr[k]);
    }
  }
  for (int j = 4 * n4; j < n; ++j) {
    const float zj = zh[j];
#pragma unroll
    for (int k = 0; k < kItems; ++k) cnt[k] += before(zj, j, zi[k], thr[k]);
  }
#pragma unroll
  for (int k = 0; k < kItems; ++k) rank[k] += (k * kThreads + t < S) ? cnt[k] : 0;
}

// Stable rank of item k (merged index k * kThreads + t) among both halves. An
// unsorted half is counted by comparison. A sorted half ranks its own items
// by index and is binary-searched by the other half's items, with the same
// tie rule (the first half before the second).
__device__ __forceinline__ void rank_items(const float* za, int s_a, bool sorted_a,
                                           const float* zb, int s_b, bool sorted_b,
                                           const float (&zi)[kItems], int (&rank)[kItems]) {
  const int t = threadIdx.x, S = s_a + s_b;
#pragma unroll
  for (int k = 0; k < kItems; ++k) rank[k] = 0;
  if (!sorted_a) count_half(za, s_a, 0, true, S, zi, rank);
  if (!sorted_b) count_half(zb, s_b, s_a, false, S, zi, rank);
  if (!sorted_a && !sorted_b) return;
  const float* arr[kItems];
  int lo[kItems], len[kItems], thr[kItems];
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    const int i = k * kThreads + t;
    arr[k] = za;
    lo[k] = len[k] = thr[k] = 0;
    if (i < S) {
      const bool in_a = i < s_a;
      if (in_a ? sorted_a : sorted_b) rank[k] += in_a ? i : i - s_a;
      if (in_a && sorted_b) {
        arr[k] = zb;
        len[k] = s_b;  // thr 0: equal depths of the second half come after
      } else if (!in_a && sorted_a) {
        len[k] = s_a;
        thr[k] = INT_MAX;  // equal depths of the first half come before
      }
    }
  }
  const int steps = 32 - __clz(max(s_a, s_b));  // each step halves len
#pragma unroll 1
  for (int step = 0; step < steps; ++step) {
#pragma unroll
    for (int k = 0; k < kItems; ++k) {
      if (len[k] > 0) {
        const int half = len[k] >> 1;
        const int j = lo[k] + half;
        if (before(arr[k][j], j, zi[k], thr[k])) {
          lo[k] = j + 1;
          len[k] -= half + 1;
        } else {
          len[k] = half;
        }
      }
    }
  }
#pragma unroll
  for (int k = 0; k < kItems; ++k) rank[k] += lo[k];
}

// ---------------------------------------------------------------- the kernel

template <typename T, bool kRelu>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
    sort_integrate_kernel(const __grid_constant__ Args<T> a) {
  constexpr int kEpv = 16 / sizeof(T);  // values per 16-byte vector
  extern __shared__ __align__(128) unsigned char smem[];
  const Plan& pl = a.plan;
  const int s_a = a.s_a, s_b = a.s_b, S = s_a + s_b;
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem);
  unsigned char* stage = smem + kHeaderBytes;
  float* red = reinterpret_cast<float*>(stage + pl.stride);
  float* wd = red + kRedFloats;  // density, then weight, by input index
  uint8_t* src = reinterpret_cast<uint8_t*>(wd + S + 1);  // input index by position

  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int c1 = a.channels, C = c1 - 1;
  const int ni = (S + kThreads - 1) / kThreads;  // sorted positions per thread, contiguous

  if (pl.staged) {
    if (t == 0) {  // the grid has at most one block per ray
      mbar_init(bar);
      asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
      issue_ray(a, blockIdx.x, stage, bar);
    }
    __syncthreads();
  }

  // Vector path: this thread's vector within a unit and the channels it keeps.
  // A warp holds gw groups of V lanes; group g takes units g, g + G, ...
  const int V = pl.vec ? pl.unit_vecs : 1;
  const int gw = 32 / V;
  const int G = kWarps * gw;
  const int unit_elems = pl.unit_rows * c1;
  const bool vlane = pl.vec && lane < gw * V;
  const int grp = warp * gw + lane / V;
  const int f0 = (lane % V) * kEpv;  // first element of this thread's vector in a unit
  const int ro_lo = f0 / c1;
  unsigned hi_mask = 0;  // elements of the vector that lie in row ro_lo + 1
#pragma unroll
  for (int e = 0; e < kEpv; ++e) hi_mask |= static_cast<unsigned>((f0 + e) / c1 - ro_lo) << e;
  const int n_units = pl.vec ? S / pl.unit_rows : 0;  // staged: each half is whole units

  int it = 0;
  for (int ray = blockIdx.x; ray < a.n_rays; ray += gridDim.x, ++it) {
    if (pl.staged) {
      mbar_wait(bar, it & 1);
    } else {
      float* z = reinterpret_cast<float*>(stage);
      for (int i = t; i < s_a; i += kThreads) z[i] = a.z_a[static_cast<size_t>(ray) * s_a + i];
      for (int i = t; i < s_b; i += kThreads) z[pl.zb_off + i] = a.z_b[static_cast<size_t>(ray) * s_b + i];
      if (a.noise)
        for (int i = t; i < S; i += kThreads) z[pl.noise_off + i] = a.noise[static_cast<size_t>(ray) * S + i];
      __syncthreads();
    }
    const float* zarea = reinterpret_cast<const float*>(stage);
    const T* vst = reinterpret_cast<const T*>(stage + pl.vals_off);

    // 1. Input sample i = k * kThreads + t: depth, density (into wd), sortedness.
    float zi[kItems];
    bool ok_a = true, ok_b = true;
#pragma unroll
    for (int k = 0; k < kItems; ++k) {
      const int i = k * kThreads + t;
      zi[k] = 0.f;
      if (i < S) {
        const bool in_a = i < s_a;
        const int zo = in_a ? i : pl.zb_off + i - s_a;
        zi[k] = zarea[zo];
        if (in_a && i + 1 < s_a) ok_a &= zi[k] <= zarea[zo + 1];
        if (!in_a && i + 1 < S) ok_b &= zi[k] <= zarea[zo + 1];
        float sig;
        if (pl.staged) {
          sig = to_f32(vst[static_cast<size_t>(i) * c1 + C]);
        } else {
          sig = to_f32(in_a ? a.v_a[(static_cast<size_t>(ray) * s_a + i) * c1 + C]
                            : a.v_b[(static_cast<size_t>(ray) * s_b + i - s_a) * c1 + C]);
        }
        if (a.noise) sig += zarea[pl.noise_off + i];
        wd[i] = clamp_density<kRelu>(sig);
      }
    }
    const bool sorted_a = __syncthreads_and(ok_a);
    const bool sorted_b = __syncthreads_and(ok_b);

    // 2. Stable rank; scatter the depth and the input index to the position.
    int rank[kItems];
    rank_items(zarea, s_a, sorted_a, zarea + pl.zb_off, s_b, sorted_b, zi, rank);
    __syncthreads();  // the sorted depths overwrite the stage's depths
    float* zs = reinterpret_cast<float*>(stage);
#pragma unroll
    for (int k = 0; k < kItems; ++k) {
      const int i = k * kThreads + t;
      if (i < S) {
        zs[rank[k]] = zi[k];
        src[rank[k]] = static_cast<uint8_t>(i);
      }
    }
    __syncthreads();

    // 3. Thread t owns sorted positions t*ni .. t*ni + ni - 1: delta, alpha,
    // the block scan of -x, the weights; depth and weights_sum in depth order.
    const float norm = a.ray_norm[ray];
    float w[kItems], zk[kItems], alpha[kItems];
    float run = 0.f;
#pragma unroll
    for (int m = 0; m < kItems; ++m) {
      const int k = t * ni + m;
      zk[m] = 0.f;
      alpha[m] = 0.f;
      w[m] = run;  // exclusive sum within the thread, for now
      if (m < ni && k < S) {
        zk[m] = zs[k];
        const float delta = (k == S - 1 ? kLastDelta : zs[k + 1] - zk[m]) * norm;
        const float x = delta * wd[src[k]];
        alpha[m] = 1.f - expf(-x);
        run -= x;
      }
    }
    const float in_warp = warp_exclusive_scan(run);
    if (lane == 31) red[warp] = in_warp + run;  // the warp's total
    __syncthreads();
    float prefix = in_warp;
    for (int v = 0; v < warp; ++v) prefix += red[v];
    float ws = 0.f, dz = 0.f;
#pragma unroll
    for (int m = 0; m < kItems; ++m) {
      w[m] = alpha[m] * expf(prefix + w[m]);
      ws += w[m];
      dz += w[m] * zk[m];
    }
    ws = warp_allsum(ws);
    dz = warp_allsum(dz);
    if (lane == 0) {
      red[kWarps + warp] = ws;
      red[2 * kWarps + warp] = dz;
    }
    __syncthreads();  // also: every density and sorted depth has been read
    ws = 0.f;
    dz = 0.f;
    for (int v = 0; v < kWarps; ++v) {
      ws += red[kWarps + v];
      dz += red[2 * kWarps + v];
    }
    const float rest = 1.f - ws;
    if (t == 0) {
      a.depth[ray] = a.last_back ? dz + rest * zs[S - 1] : dz;
      a.wsum[ray] = a.last_back ? ws + rest : ws;
    }
#pragma unroll
    for (int m = 0; m < kItems; ++m) {
      const int k = t * ni + m;
      if (m < ni && k < S) wd[src[k]] = (a.last_back && k == S - 1) ? w[m] + rest : w[m];
    }
    __syncthreads();
    const float white = a.white_back ? rest : 0.f;

    // 4. feat[c] = sum_i w_i vals[i, c] over the input order.
    float* out = a.feat + static_cast<size_t>(ray) * C;
    if (pl.vec) {
      float acc[kEpv];
#pragma unroll
      for (int e = 0; e < kEpv; ++e) acc[e] = 0.f;
      if (vlane) {
        const unsigned char* base = stage + pl.vals_off + f0 * sizeof(T);
#pragma unroll 4
        for (int u = grp; u < n_units; u += G) {
          const int row = u * pl.unit_rows + ro_lo;
          const float w0 = wd[row], w1 = wd[row + 1];
          float v[kEpv];
          unpack(*reinterpret_cast<const uint4*>(base + static_cast<size_t>(u) * unit_elems * sizeof(T)), v);
#pragma unroll
          for (int e = 0; e < kEpv; ++e) acc[e] = fmaf((hi_mask >> e) & 1u ? w1 : w0, v[e], acc[e]);
        }
      }
      // Fold the warp's groups onto its first V lanes (same vector position),
      // then the warps: slot warp*unit_elems + f0 + e of `part`.
      float own[kEpv];
#pragma unroll
      for (int e = 0; e < kEpv; ++e) own[e] = acc[e];
      for (int g = 1; g < gw; ++g) {
#pragma unroll
        for (int e = 0; e < kEpv; ++e) acc[e] += __shfl_down_sync(kFull, own[e], g * V);
      }
      __syncthreads();  // the values are summed: `part` overlays them
      float* part = reinterpret_cast<float*>(stage + pl.vals_off);
      if (lane < V) {
#pragma unroll
        for (int e = 0; e < kEpv; ++e) part[warp * unit_elems + f0 + e] = acc[e];
      }
      __syncthreads();
      for (int c = t; c < C; c += kThreads) {
        float f = 0.f;
        for (int v = 0; v < kWarps; ++v)
          for (int ro = 0; ro < pl.unit_rows; ++ro) f += part[v * unit_elems + ro * c1 + c];
        out[c] = f + white;
      }
    } else {
      float acc[kChans];
#pragma unroll
      for (int q = 0; q < kChans; ++q) acc[q] = 0.f;
      T* buf = reinterpret_cast<T*>(stage + pl.vals_off);
      for (int r0 = 0; r0 < S; r0 += pl.chunk_rows) {
        const int r1 = min(S, r0 + pl.chunk_rows);
        if (!pl.staged) {  // copy rows [r0, r1) of this ray into the stage
          if (r0 < s_a) {
            const T* g = a.v_a + (static_cast<size_t>(ray) * s_a + r0) * c1;
            const int n = (min(r1, s_a) - r0) * c1;
            for (int e = t; e < n; e += kThreads) buf[e] = g[e];
          }
          if (r1 > s_a) {
            const int rb0 = max(r0, s_a);
            const T* g = a.v_b + (static_cast<size_t>(ray) * s_b + rb0 - s_a) * c1;
            const int n = (r1 - rb0) * c1;
            T* d = buf + (rb0 - r0) * c1;
            for (int e = t; e < n; e += kThreads) d[e] = g[e];
          }
          __syncthreads();
        }
        const T* rows = pl.staged ? buf + static_cast<size_t>(r0) * c1 : buf;
        for (int r = r0; r < r1; ++r) {
          const float wr = wd[r];
          const T* row = rows + static_cast<size_t>(r - r0) * c1;
#pragma unroll
          for (int q = 0; q < kChans; ++q) {
            const int c = t + kThreads * q;
            if (c < C) acc[q] = fmaf(wr, to_f32(row[c]), acc[q]);
          }
        }
        __syncthreads();
      }
#pragma unroll
      for (int q = 0; q < kChans; ++q) {
        const int c = t + kThreads * q;
        if (c < C) out[c] = acc[q] + white;
      }
    }
    // The stage, wd and src are rewritten for the next ray. Each thread's
    // generic-proxy writes to the stage are ordered before the next ray's
    // bulk copies into it: a proxy fence by every thread, then the barrier.
    if (pl.staged) asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
    __syncthreads();
    const int next = ray + gridDim.x;
    if (pl.staged && t == 0 && next < a.n_rays) issue_ray(a, next, stage, bar);
  }
}

template <typename T, bool kRelu>
int launch(int device, const Args<T>& a, cudaStream_t st) {
  // Per instantiation: the shared-memory attribute and occupancy of the last plan.
  static int set_smem = -1, blocks_per_sm = 0;
  auto* kernel = sort_integrate_kernel<T, kRelu>;
  const int smem = smem_bytes(a.plan, a.s_a + a.s_b);
  cudaError_t err;
  if (smem != set_smem) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks_per_sm, kernel, kThreads, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    set_smem = smem;
  }
  if (blocks_per_sm < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
  int sms = 0;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int grid = a.n_rays < blocks_per_sm * sms ? a.n_rays : blocks_per_sm * sms;
  kernel<<<grid, kThreads, smem, st>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(int device, const void* z_a, const void* v_a, int s_a, const void* z_b,
             const void* v_b, int s_b, const void* ray_norm, const void* noise, int n_rays,
             int channels, int relu, int last_back, int white_back, void* feat, void* depth,
             void* wsum, cudaStream_t st) {
  Args<T> a;
  a.z_a = static_cast<const float*>(z_a);
  a.v_a = static_cast<const T*>(v_a);
  a.s_a = s_a;
  a.z_b = static_cast<const float*>(z_b);
  a.v_b = static_cast<const T*>(v_b);
  a.s_b = s_b;
  a.ray_norm = static_cast<const float*>(ray_norm);
  a.noise = static_cast<const float*>(noise);
  a.n_rays = n_rays;
  a.channels = channels;
  a.last_back = last_back;
  a.white_back = white_back;
  const void* copied[] = {z_a, v_a, z_b, v_b, noise};  // a null noise is aligned
  bool aligned = true;  // the bulk copies need 16-byte-aligned addresses
  for (const void* p : copied) aligned &= (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
  a.plan = make_plan(s_a, s_b, channels, sizeof(T), noise != nullptr, aligned);
  a.feat = static_cast<float*>(feat);
  a.depth = static_cast<float*>(depth);
  a.wsum = static_cast<float*>(wsum);
  return relu ? launch<T, true>(device, a, st) : launch<T, false>(device, a, st);
}

}  // namespace

extern "C" int ide3d_sort_integrate(
    int device, const void* z_a, const void* v_a, int s_a, const void* z_b, const void* v_b,
    int s_b, const void* ray_norm, const void* noise, int n_rays, int channels, int vals_bf16,
    int relu, int last_back, int white_back, void* feat, void* depth, void* wsum,
    void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const auto st = static_cast<cudaStream_t>(stream);
  if (vals_bf16)
    return dispatch<__nv_bfloat16>(device, z_a, v_a, s_a, z_b, v_b, s_b, ray_norm, noise, n_rays,
                                   channels, relu, last_back, white_back, feat, depth, wsum,
                                   st);
  return dispatch<float>(device, z_a, v_a, s_a, z_b, v_b, s_b, ray_norm, noise, n_rays, channels,
                         relu, last_back, white_back, feat, depth, wsum, st);
}
