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
#include <cstring>

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
  int gg_off;       // bytes: the gg slab's offset in the stage (the double backward), else 0
};

int round_up(int n, int m) { return (n + m - 1) / m * m; }

// `gg`: the stage also holds a second slab of the values' shape after them
// (the double backward's gg); `max_stage` bounds a staged ray's bytes.
Plan make_plan(int s_a, int s_b, int channels, int esize, bool noise, bool gg, bool aligned,
               int max_stage) {
  const int S = s_a + s_b, rb = channels * esize;
  Plan p;
  p.zb_off = round_up(s_a, 4);
  p.noise_off = p.zb_off + round_up(s_b, 4);
  p.vals_off = 4 * (p.noise_off + (noise ? round_up(S, 4) : 0));
  p.gg_off = gg ? p.vals_off + S * rb : 0;
  int g = 16;  // gcd(rb, 16)
  while (rb % g) g >>= 1;
  p.unit_rows = 16 / g;
  p.unit_vecs = p.unit_rows * rb / 16;
  p.vec = p.unit_vecs <= 32 && rb >= 16;
  p.staged = aligned && s_a % 4 == 0 && s_b % 4 == 0 && (s_a * rb) % 16 == 0 &&
             (s_b * rb) % 16 == 0 && p.vals_off + (gg ? 2 : 1) * S * rb <= max_stage &&
             (p.vec || !gg);  // the double backward stages rows its vector sums take
  int bytes;
  if (p.staged) {
    p.chunk_rows = S;
    const int partials = p.vec ? 4 * kWarps * p.unit_rows * channels : 0;
    bytes = gg ? p.gg_off + S * rb  // the double backward keeps its partials outside the stage
               : p.vals_off + (S * rb > partials ? S * rb : partials);
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

// Thread 0: fill `stage` with ray `ray`'s depths, noise and values, and with
// kGg (the double backward) its slab of gg_a, gg_b at the plan's gg_off.
template <typename T, bool kGg = false>
__device__ void issue_ray(const Args<T>& a, int ray, unsigned char* stage, uint64_t* bar,
                          const T* gg_a = nullptr, const T* gg_b = nullptr) {
  const Plan& pl = a.plan;
  const int s_a = a.s_a, s_b = a.s_b, S = s_a + s_b;
  const uint32_t rb = a.channels * sizeof(T);
  float* z = reinterpret_cast<float*>(stage);
  unsigned char* v = stage + pl.vals_off;
  mbar_expect_tx(bar, S * 4u + S * rb * (kGg ? 2u : 1u) + (a.noise ? S * 4u : 0u));
  bulk_load(z, a.z_a + static_cast<size_t>(ray) * s_a, s_a * 4u, bar);
  bulk_load(z + pl.zb_off, a.z_b + static_cast<size_t>(ray) * s_b, s_b * 4u, bar);
  if (a.noise) bulk_load(z + pl.noise_off, a.noise + static_cast<size_t>(ray) * S, S * 4u, bar);
  bulk_load(v, a.v_a + static_cast<size_t>(ray) * s_a * a.channels, s_a * rb, bar);
  bulk_load(v + s_a * rb, a.v_b + static_cast<size_t>(ray) * s_b * a.channels, s_b * rb, bar);
  if (kGg) {
    bulk_load(stage + pl.gg_off, gg_a + static_cast<size_t>(ray) * s_a * a.channels, s_a * rb, bar);
    bulk_load(stage + pl.gg_off + s_a * rb, gg_b + static_cast<size_t>(ray) * s_b * a.channels,
              s_b * rb, bar);
  }
}

// The block: copy value rows [r0, r1) of ray `ray` (both halves) into `buf`
// by plain loads, for the streamed plan.
template <typename T>
__device__ __forceinline__ void copy_rows(const Args<T>& a, int ray, int r0, int r1, T* buf) {
  const int t = threadIdx.x, s_a = a.s_a, s_b = a.s_b, c1 = a.channels;
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
        if (!pl.staged) {
          copy_rows(a, ray, r0, r1, buf);
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

// ---------------------------------------------------------------- the backward
//
// The gradient of K1 with respect to both value slabs. It stands for the JAX
// package's autodiff of the fine composite `integrate_rays_merged`
// (ide3d_tpu/render/integration.py:85), whose forward the TPU kernel
// `sort_integrate_pallas` (ide3d_tpu/ops/pallas/ray_march.py:121) computes.
// Given the cotangents g_feat [n_rays, C], g_depth [n_rays], g_wsum [n_rays],
// and nothing saved between the passes, it recomputes the forward's stable
// order, x_k = delta_k * density_k, alpha_k, T_k and w_k (the same arithmetic
// as the forward), then per sorted sample k
//   a_k = g_feat . f_k + g_depth z_k + g_wsum,
//   L_k = a_k - [last_back] a_{S-1} - [white_back] sum(g_feat),
//   dL/df_k = w'_k g_feat          (w' the weights after last_back),
//   dL/dx_k = L_k T_k e^{-x_k} - sum_{j>k} L_j w_j   (a reverse block scan),
//   dL/dsigma_k = dL/dx_k delta_k density'(sigma_k + noise_k),
// and writes each input row [dL/df, dL/dsigma] in the values' dtype. The last
// sample (delta 1e10 |ray_d|) has an empty suffix, set to 0 rather than
// subtracted, and its e^{-x} underflows to 0 before it meets delta: no inf * 0.
//
// Bound on the H100: bytes. A ray reads its values once and writes a gradient
// as large: at B=4, R=4096, S=96+96, C+1=52, bf16 that is 40,920 B a ray
// (19,968 of values, 19,968 of gradient, 768 of depths, 216 of cotangents and
// |ray_d|), 670,433,280 B in all, 200.1 us at 3.35 TB/s. The instruction
// time of the arithmetic (the forward's rank and scans again, two passes over
// the row values) is of the same order, so the design keeps the bytes moving
// asynchronously and the instructions few:
//   1. Staged, asynchronous reads, the forward's own: one stage a block filled
//      by TMA bulk copies (make_plan, issue_ray) and a persistent grid sized
//      by occupancy, so the copies of the SM's other blocks are in flight
//      while one block ranks and scans. The depths are copied out of the
//      stage for the rank; g_feat (C fp32, not a multiple of 16 bytes) is a
//      plain load, prefetched into registers one ray ahead with the scalars.
//   2. Wide reads: a thread takes whole rows, its own samples', and reads
//      them from the stage in the widest chunk that divides a row (8 bytes at
//      the training shape: 13 loads a row, rows 104 bytes apart falling on
//      distinct banks), g_feat broadcast from shared memory; sigma_i comes
//      from the stage in the first pass over the samples, as the forward's.
//   3. Wide, asynchronous writes: the same threads write their gradient rows
//      over the stage's values (read by then) in the same chunks, and one
//      thread sends each half's slab with a TMA bulk store
//      (cp.async.bulk.global.shared::cta.bulk_group), full lines, no division
//      per element. The stage is refilled with the next ray once the store
//      has read it (wait_group.read), so one stage a block serves both
//      directions and 9 blocks (kMinBlocks, 9 rays) stay resident per SM, as
//      for the forward. Measured on the H100: a second stage for the
//      gradient (5 blocks a SM, the next ray's copies sent before the rank)
//      and 6 or 8 blocks a SM were slower (PERF.md).
// Shapes the stage does not take (as the forward: a half that is not a
// multiple of 16 bytes, a pointer, the gradients' included, that is not
// 16-byte aligned, a ray above 64 KB) run streamed: depths and noise read
// directly, the values copied into the stage in row chunks by the block, a
// warp per row for the dots, and the gradient written flat with its row and
// column stepped, not divided.

template <typename T>
struct BwdArgs {
  Args<T> f;             // the forward's inputs and launch plan; its outputs are unused
  const float* g_feat;   // [n_rays, C]
  const float* g_depth;  // [n_rays]
  const float* g_wsum;   // [n_rays]
  T* gv_a;               // [n_rays, s_a, channels]
  T* gv_b;               // [n_rays, s_b, channels]
};

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// Exclusive suffix sum over the warp's lanes (lane 31 gets 0); `total` the warp's sum.
__device__ __forceinline__ float warp_exclusive_suffix(float v, float& total) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const float n = __shfl_down_sync(kFull, v, o);
    if (lane + o < 32) v += n;
  }
  total = __shfl_sync(kFull, v, 0);
  const float e = __shfl_down_sync(kFull, v, 1);
  return lane == 31 ? 0.f : e;
}

// Shared -> global bulk copy (dst, src and bytes multiples of 16), in the
// issuing thread's bulk group.
__device__ __forceinline__ void bulk_store(void* dst, const void* src, uint32_t bytes) {
  asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;" ::"l"(dst),
               "r"(smem_addr(src)), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;" ::: "memory");
}
// Until the thread's committed bulk stores have read their shared memory.
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read 0;" ::: "memory");
}
// Until they have completed.
__device__ __forceinline__ void bulk_wait() {
  asm volatile("cp.async.bulk.wait_group 0;" ::: "memory");
}

// W bytes as one load or store.
template <int W> struct Bits;
template <> struct Bits<16> { using type = uint4; };
template <> struct Bits<8> { using type = uint2; };
template <> struct Bits<4> { using type = uint32_t; };
template <> struct Bits<2> { using type = uint16_t; };

// g_feat . f of one value row of c1 values read in W-byte chunks (gf is 0 at
// the sigma column), summed in column order.
template <typename T, int W>
__device__ __forceinline__ float row_dot(const T* row, const float* gf, int c1) {
  constexpr int kN = W / sizeof(T);
  float acc = 0.f;
  for (int c = 0; c < c1; c += kN) {
    const auto r = *reinterpret_cast<const typename Bits<W>::type*>(row + c);
    T e[kN];
    memcpy(e, &r, W);
#pragma unroll
    for (int q = 0; q < kN; ++q) acc = fmaf(gf[c + q], to_f32(e[q]), acc);
  }
  return acc;
}

// The gradient row [w g_feat, ds] of one sample into `row`, in W-byte chunks.
template <typename T, int W>
__device__ __forceinline__ void row_grad(T* row, const float* gf, int c1, float w, float ds) {
  constexpr int kN = W / sizeof(T);
  for (int c = 0; c < c1; c += kN) {
    T e[kN];
#pragma unroll
    for (int q = 0; q < kN; ++q) e[q] = from_f32<T>(w * gf[c + q]);
    typename Bits<W>::type r;
    memcpy(&r, e, W);
    *reinterpret_cast<typename Bits<W>::type*>(row + c) = r;
  }
  row[c1 - 1] = from_f32<T>(ds);
}

// Shared memory of the backward: the mbarrier; the stage (the forward's plan;
// the gradient rows overlay its values once they are read); the depths of
// both halves as the stage lays them out (the sorted depths overlay them once
// ranked); the per-warp sums; g_feat in two buffers of round_up(C + 1, 4),
// 0 from column C on (by ray parity, so the next ray's never overwrites one
// still read); then by input index: density -> w'; density' -> dL/dsigma;
// g_feat . f_i; the input index of each sorted position (S bytes).
int bwd_smem_bytes(const Plan& p, int S, int channels) {
  return kHeaderBytes + p.stride +
         4 * (p.noise_off + kRedFloats + 2 * round_up(channels, 4) + 3 * S) + S;
}

template <typename T, bool kRelu>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
    sort_integrate_backward_kernel(const __grid_constant__ BwdArgs<T> a) {
  extern __shared__ __align__(128) unsigned char smem[];
  const Args<T>& f = a.f;
  const Plan& pl = f.plan;
  const int s_a = f.s_a, s_b = f.s_b, S = s_a + s_b;
  const int c1 = f.channels, C = c1 - 1, C4 = (c1 + 3) & ~3;
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem);
  unsigned char* stage = smem + kHeaderBytes;
  T* vst = reinterpret_cast<T*>(stage + pl.vals_off);       // the staged value rows
  float* zc = reinterpret_cast<float*>(stage + pl.stride);  // depths, then sorted depths
  float* red = zc + pl.noise_off;
  float* gfs = red + kRedFloats;  // g_feat, two buffers
  float* wd = gfs + 2 * C4;       // density, then w', by input index
  float* dsig = wd + S;           // density', then dL/dsigma, by input index
  float* dot = dsig + S;          // g_feat . f_i, by input index
  uint8_t* src = reinterpret_cast<uint8_t*>(dot + S);  // input index by position

  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int ni = (S + kThreads - 1) / kThreads;  // sorted positions per thread, contiguous
  int W = 16;  // staged: a thread's row passes use the widest chunk that divides a row
  while ((c1 * static_cast<int>(sizeof(T))) % W) W >>= 1;
  // Streamed writes: element t + kThreads * n of a half, its (row, col) stepped.
  const int step_rows = kThreads / c1, step_cols = kThreads % c1;

  for (int c = C + t; c < C4; c += kThreads) gfs[c] = gfs[C4 + c] = 0.f;
  if (pl.staged && t == 0) {  // the grid has at most one block per ray
    mbar_init(bar);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    issue_ray(f, blockIdx.x, stage, bar);
  }
  __syncthreads();

  // The cotangents and |ray_d| of a ray, loaded one ray ahead.
  float pf_gf[kChans], pf_gd, pf_gw, pf_norm;
  auto prefetch = [&](int r) {
#pragma unroll
    for (int q = 0; q < kChans; ++q) {
      const int c = t + kThreads * q;
      pf_gf[q] = c < C ? a.g_feat[static_cast<size_t>(r) * C + c] : 0.f;
    }
    pf_gd = a.g_depth[r];
    pf_gw = a.g_wsum[r];
    pf_norm = f.ray_norm[r];
  };
  prefetch(blockIdx.x);

  int it = 0;
  for (int ray = blockIdx.x; ray < f.n_rays; ray += gridDim.x, ++it) {
    const size_t rs = ray;
    const float gd = pf_gd, gw = pf_gw, norm = pf_norm;
    float* gf = gfs + (it & 1) * C4;
#pragma unroll
    for (int q = 0; q < kChans; ++q) {
      const int c = t + kThreads * q;
      if (c < C) gf[c] = pf_gf[q];
    }
    if (pl.staged) mbar_wait(bar, it & 1);
    const float* zst = reinterpret_cast<const float*>(stage);

    // 1. Input sample i = k * kThreads + t: its depth (into zc), sigma + noise.
    float zi[kItems], sg[kItems];
#pragma unroll
    for (int k = 0; k < kItems; ++k) {
      const int i = k * kThreads + t;
      zi[k] = sg[k] = 0.f;
      if (i < S) {
        const bool in_a = i < s_a;
        const int zo = in_a ? i : pl.zb_off + i - s_a;
        if (pl.staged) {
          zi[k] = zst[zo];
          sg[k] = to_f32(vst[static_cast<size_t>(i) * c1 + C]);
          if (f.noise) sg[k] += zst[pl.noise_off + i];
        } else {
          zi[k] = in_a ? f.z_a[rs * s_a + i] : f.z_b[rs * s_b + i - s_a];
          sg[k] = to_f32(in_a ? f.v_a[(rs * s_a + i) * c1 + C]
                              : f.v_b[(rs * s_b + i - s_a) * c1 + C]);
          if (f.noise) sg[k] += f.noise[rs * S + i];
        }
        zc[zo] = zi[k];
      }
    }
    __syncthreads();  // zc and g_feat
    bool ok_a = true, ok_b = true;
#pragma unroll
    for (int k = 0; k < kItems; ++k) {
      const int i = k * kThreads + t;
      if (i < S) {
        const bool in_a = i < s_a;
        const int zo = in_a ? i : pl.zb_off + i - s_a;
        if (in_a && i + 1 < s_a) ok_a &= zi[k] <= zc[zo + 1];
        if (!in_a && i + 1 < S) ok_b &= zi[k] <= zc[zo + 1];
      }
    }

    // 2. g_feat . f_i of every value row, into dot. Staged: thread t takes its
    // samples' rows, W bytes at a time (rows 104 or 208 bytes apart hit
    // distinct banks). Streamed: the rows come in chunks, a warp a row.
    if (pl.staged) {
#pragma unroll
      for (int k = 0; k < kItems; ++k) {
        const int i = k * kThreads + t;
        if (i < S) {
          const T* row = vst + static_cast<size_t>(i) * c1;
          dot[i] = W == 16 ? row_dot<T, 16>(row, gf, c1)
                   : W == 8 ? row_dot<T, 8>(row, gf, c1)
                   : W == 4 ? row_dot<T, 4>(row, gf, c1)
                            : row_dot<T, sizeof(T)>(row, gf, c1);
        }
      }
    } else {
      T* buf = vst;
      for (int r0 = 0; r0 < S; r0 += pl.chunk_rows) {
        const int r1 = min(S, r0 + pl.chunk_rows);
        copy_rows(f, ray, r0, r1, buf);
        __syncthreads();
        for (int r = r0 + warp; r < r1; r += kWarps) {  // a warp a row
          const T* row = buf + static_cast<size_t>(r - r0) * c1;
          float acc = 0.f;
          for (int c = lane; c < C; c += 32) acc = fmaf(gf[c], to_f32(row[c]), acc);
          acc = warp_allsum(acc);
          if (lane == 0) dot[r] = acc;
        }
        __syncthreads();  // the chunk is read before the next one lands
      }
    }
    const bool sorted_a = __syncthreads_and(ok_a);
    const bool sorted_b = __syncthreads_and(ok_b);
    const int next = ray + gridDim.x;
    if (next < f.n_rays) prefetch(next);

    // 3. Input sample i: density and its derivative; sum(g_feat), the
    // white_back term (read after the rank's barrier).
#pragma unroll
    for (int k = 0; k < kItems; ++k) {
      const int i = k * kThreads + t;
      if (i < S) {
        wd[i] = clamp_density<kRelu>(sg[k]);
        dsig[i] = kRelu ? (sg[k] > 0.f ? 1.f : 0.f) : 1.f / (1.f + expf(-sg[k]));
      }
    }
    if (warp == 0) {
      float g = 0.f;
      for (int c = lane; c < C; c += 32) g += gf[c];
      g = warp_allsum(g);
      if (lane == 0) red[3 * kWarps] = g;
    }

    // 4. The forward's stable rank; the sorted depths overlay zc.
    int rank[kItems];
    rank_items(zc, s_a, sorted_a, zc + pl.zb_off, s_b, sorted_b, zi, rank);
    __syncthreads();
    float* zs = zc;
#pragma unroll
    for (int k = 0; k < kItems; ++k) {
      const int i = k * kThreads + t;
      if (i < S) {
        zs[rank[k]] = zi[k];
        src[rank[k]] = static_cast<uint8_t>(i);
      }
    }
    __syncthreads();

    // 5. The forward again: delta, x, alpha, T (block scan of -x), w; sum of w.
    float w[kItems], tx[kItems], delta[kItems], ex[kItems], zk[kItems];
    float run = 0.f;
#pragma unroll
    for (int m = 0; m < kItems; ++m) {
      const int k = t * ni + m;
      zk[m] = delta[m] = 0.f;
      ex[m] = 1.f;
      w[m] = run;   // exclusive sum within the thread, for now
      tx[m] = 0.f;  // alpha, for now
      if (m < ni && k < S) {
        zk[m] = zs[k];
        delta[m] = (k == S - 1 ? kLastDelta : zs[k + 1] - zk[m]) * norm;
        const float x = delta[m] * wd[src[k]];
        ex[m] = expf(-x);
        tx[m] = 1.f - ex[m];
        run -= x;
      }
    }
    const float in_warp = warp_exclusive_scan(run);
    if (lane == 31) red[warp] = in_warp + run;
    __syncthreads();
    float prefix = in_warp;
    for (int v = 0; v < warp; ++v) prefix += red[v];
    float ws = 0.f;
#pragma unroll
    for (int m = 0; m < kItems; ++m) {
      const float trans = expf(prefix + w[m]);
      w[m] = tx[m] * trans;  // alpha * T, as the forward computes it
      tx[m] = trans;
      ws += w[m];
    }
    ws = warp_allsum(ws);
    if (lane == 0) red[kWarps + warp] = ws;
    __syncthreads();
    ws = 0.f;
    for (int v = 0; v < kWarps; ++v) ws += red[kWarps + v];
    const float rest = 1.f - ws;

    // 6. L_k, and the exclusive suffix sum of L_j w_j in depth order.
    const float a_last = dot[src[S - 1]] + gd * zs[S - 1] + gw;
    const float shift = (f.last_back ? a_last : 0.f) + (f.white_back ? red[3 * kWarps] : 0.f);
    float L[kItems], suf[kItems];
    float acc = 0.f;
#pragma unroll
    for (int m = kItems - 1; m >= 0; --m) {
      const int k = t * ni + m;
      L[m] = 0.f;
      if (m < ni && k < S) L[m] = dot[src[k]] + gd * zk[m] + gw - shift;
      suf[m] = acc;
      acc += L[m] * w[m];
    }
    float warp_total;
    float after = warp_exclusive_suffix(acc, warp_total);
    if (lane == 0) red[2 * kWarps + warp] = warp_total;
    __syncthreads();
    for (int v = warp + 1; v < kWarps; ++v) after += red[2 * kWarps + v];

    // 7. dL/dsigma and w' by input index.
#pragma unroll
    for (int m = 0; m < kItems; ++m) {
      const int k = t * ni + m;
      if (m < ni && k < S) {
        const int i = src[k];
        const float suffix = k == S - 1 ? 0.f : after + suf[m];
        const float dx = L[m] * tx[m] * ex[m] - suffix;
        dsig[i] = dx * (delta[m] * dsig[i]);
        wd[i] = (f.last_back && k == S - 1) ? w[m] + rest : w[m];
      }
    }
    __syncthreads();

    // 8. The gradient rows [w'_i g_feat, dL/dsigma_i]. Staged: thread t writes
    // its samples' rows over the stage's values, W bytes at a time; one
    // thread sends each half's slab with a TMA bulk store and, once the store
    // has read the stage, refills it with the next ray. Streamed: flat over
    // each half's slab, neighbouring threads on neighbouring values.
    if (pl.staged) {
#pragma unroll
      for (int k = 0; k < kItems; ++k) {
        const int i = k * kThreads + t;
        if (i < S) {
          T* row = vst + static_cast<size_t>(i) * c1;
          if (W == 16) row_grad<T, 16>(row, gf, c1, wd[i], dsig[i]);
          else if (W == 8) row_grad<T, 8>(row, gf, c1, wd[i], dsig[i]);
          else if (W == 4) row_grad<T, 4>(row, gf, c1, wd[i], dsig[i]);
          else row_grad<T, sizeof(T)>(row, gf, c1, wd[i], dsig[i]);
        }
      }
      asm volatile("fence.proxy.async.shared::cta;" ::: "memory");  // the rows, to the bulk store
      __syncthreads();
      if (t == 0) {
        const uint32_t rb = c1 * sizeof(T);
        bulk_store(a.gv_a + rs * s_a * c1, vst, s_a * rb);
        bulk_store(a.gv_b + rs * s_b * c1, vst + static_cast<size_t>(s_a) * c1, s_b * rb);
        bulk_commit();
        if (next < f.n_rays) {
          bulk_wait_read();
          issue_ray(f, next, stage, bar);
        }
      }
    } else {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int first = h ? s_a : 0;
        const int n = (h ? s_b : s_a) * c1;
        T* out = h ? a.gv_b + rs * s_b * c1 : a.gv_a + rs * s_a * c1;
        int row = t / c1, col = t % c1;
        for (int e = t; e < n; e += kThreads) {
          const int i = first + row;
          out[e] = from_f32<T>(col < C ? wd[i] * gf[col] : dsig[i]);
          row += step_rows;
          col += step_cols;
          if (col >= c1) {
            col -= c1;
            ++row;
          }
        }
      }
    }
  }
  if (pl.staged && t == 0) bulk_wait();  // the last slabs are written before the block ends
}

// ---------------------------------------------------------------- the double backward
//
// The gradient of K1's backward (above) with respect to its differentiable
// inputs: both value slabs and the three cotangents. It stands for the JAX
// package's second-order autodiff of the fine composite
// `integrate_rays_merged` (ide3d_tpu/render/integration.py:85), which the
// path-length regularizer (`pl_penalty_fn`, ide3d_tpu/train/gan.py:306)
// differentiates twice. Notation per ray, k in depth order, i = src[k] the
// input row of position k, f_k its C features and s_k its sigma + noise:
//   d_k = act(s_k), d'_k, d''_k (softplus: sigmoid(s), sigmoid(s)(1 -
//   sigmoid(s)); relu: [s > 0], 0); delta_k = (z_{k+1} - z_k)|ray_d|, the last
//   1e10|ray_d|; x_k = delta_k d_k; e_k = exp(-x_k); T_k = exp(-sum_{j<k} x_j);
//   T'_k = T_k e_k = T_{k+1}; w_k = (1 - e_k) T_k; W = sum w;
//   a_k = g_feat . f_k + g_depth z_k + g_wsum;
//   L_k = a_k - [last_back] a_{S-1} - [white_back] sum(g_feat);
//   D_k = L_k T'_k - sum_{j>k} L_j w_j            (the backward's dL/dx_k);
//   w'_k = w_k + [last_back][k = S-1](1 - W).
// The backward writes the row [w'_k g_feat, D_k delta_k d'_k] for sample i.
// Given the cotangents of those rows, gg_f (C columns) and gg_r (the sigma
// column), M = sum_k w'_k u_k + sum_k v_k D_k with
//   u_k = g_feat . gg_f_k,  v_k = gg_r_k delta_k d'_k.
// Writing P_k = sum_{j<k} v_j and c_k = v_k T'_k - w_k P_k, the second sum is
// sum_k c_k L_k (swap the order of the double sum), so with C_s = sum c and
// c'_k = c_k - [last_back][k = S-1] C_s (the a_{S-1} inside every L_k):
//   dM/dg_feat  = sum_k w'_k gg_f_k + sum_k c'_k f_k - [white_back] C_s
//   dM/dg_depth = sum_k c'_k z_k,   dM/dg_wsum = sum_k c'_k
//   dM/df_k     = c'_k g_feat
// and through x (v held fixed) and through d'_k inside v_k:
//   U_k = u_k - [last_back] u_{S-1}   (w' enters M as sum_k w_k U_k + const)
//   dM/dx_k = U_k T'_k - sum_{j>k} U_j w_j - L_k T'_k (P_k + v_k)
//             - sum_{j>k} c_j L_j
//   dM/ds_k = dM/dx_k delta_k d'_k + D_k gg_r_k delta_k d''_k.
// (dT'_j/dx_m = -T'_j [m <= j] and dw_j/dx_m = [m = j] T'_j - [m < j] w_j give
// the two scans of the x term.) Each of these is a block scan or sum over the
// ray's sorted positions; the last position's suffixes are empty, and its
// e^{-x} underflows to 0 before it meets the 1e10 delta: no inf * 0.
//
// Bound on the H100: bytes. A ray reads its values, the gradient's cotangent
// gg (as large), its depths, noise and cotangents, and writes a gradient as
// large as its values and C + 2 floats: at B=4, R=4096, S=96+96, C+1=52, bf16
// that is 1,001,062,400 B in all (the backward's 670 MB plus gg and the
// cotangents' gradients), 298.8 us at 3.35 TB/s. The arithmetic (the
// forward's rank and scans again, two dots and a channel sum a row) is of the
// same order in instructions, so the design, the forward's and the
// backward's plan extended to two slabs, keeps the bytes moving
// asynchronously and the instructions and barriers few:
//   1. Staged, asynchronous reads: one stage a block holds the ray's depths,
//      noise, value slab and gg slab, filled by TMA bulk copies (make_plan and
//      issue_ray with the gg slab). The grid is persistent, 4-warp blocks
//      sized by occupancy (5 a SM at the training shape, the registers
//      budgeted for them); the next ray's copies go out as soon as the
//      gradient's bulk store has read the stage. Each slab is read from HBM
//      once; g_feat and the scalars are prefetched a ray ahead.
//   2. The dots g_feat . f_i and g_feat . gg_f_i: a thread a row, from the
//      stage in the widest chunk that divides a row, both in one pass (row_dot2).
//   3. The forward's rank (a vote; a sorted half ranks its samples by index
//      and is binary-searched by the other) and its layout of kItems sorted
//      positions a thread. The derivation's seven scans and sums run as two
//      block passes, each a warp scan and one barrier: the prefixes of -x and
//      v; then the suffixes of L w and U w + c L with the sums of w, c and
//      c (z - [last_back] z_{S-1}), which give W, C_s, dM/dg_depth and
//      dM/dg_wsum. Six block barriers a ray.
//   4. dM/dg_feat = sum_i w'_i gg_f_i + c'_i f_i is the forward's vector
//      channel sum over both staged slabs (a lane keeps fixed channels; the
//      sums fold by shuffles, then across the warps in a fixed order). In the
//      same pass each lane writes the gradient [c'_i g_feat, dM/dsigma_i] of
//      the 16-byte vector it has just read over it: its columns are fixed,
//      so no division, and 16-byte stores. One thread sends each half with a
//      TMA bulk store.
// Shapes the stage does not take (a half that is not a multiple of 16 bytes,
// a pointer, gg and the outputs included, that is not 16-byte aligned, a row
// below 16 bytes or a unit above 32 vectors, or a ray whose two slabs and
// depths exceed kMaxDblStageBytes, e.g. S=256, C+1=256 fp32) run streamed, on
// the first design below (a block of 256 threads a ray, the slabs read from
// device memory), at a grid sized by occupancy. fp32 at the training shape
// (80 KB of slabs) is staged, 2 blocks a SM.

constexpr int kMaxDblStageBytes = 96 * 1024;  // a ray above this is streamed
constexpr int kDblMinBlocks = 5;               // blocks per SM the registers are budgeted for
constexpr int kDbThreads = kMaxSamples;        // streamed: a thread a sorted position
constexpr int kDbWarps = kDbThreads / 32;

template <typename T>
struct DblArgs {
  Args<T> f;             // the forward's inputs and the plan; its outputs are unused
  const float* g_feat;   // [n_rays, C]
  const float* g_depth;  // [n_rays]
  const float* g_wsum;   // [n_rays]
  const T* gg_a;         // [n_rays, s_a, channels], the cotangent of the backward's gv_a
  const T* gg_b;         // [n_rays, s_b, channels]
  T* d_a;                // [n_rays, s_a, channels]
  T* d_b;                // [n_rays, s_b, channels]
  float* d_gfeat;        // [n_rays, C]
  float* d_gdepth;       // [n_rays]
  float* d_gwsum;        // [n_rays]
};

// fp32 -> 16 bytes of values, the inverse of unpack.
__device__ __forceinline__ uint4 pack(const float (&v)[8]) {  // 8 bf16
  uint32_t w[4];
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(v[2 * q], v[2 * q + 1]);
    memcpy(&w[q], &h, 4);
  }
  return make_uint4(w[0], w[1], w[2], w[3]);
}
__device__ __forceinline__ uint4 pack(const float (&v)[4]) {  // 4 fp32
  return make_uint4(__float_as_uint(v[0]), __float_as_uint(v[1]), __float_as_uint(v[2]),
                    __float_as_uint(v[3]));
}

// g_feat . a and g_feat . b of two value rows of c1 values, read in W-byte
// chunks (gf is 0 at the sigma column), each summed in column order: one
// pass over g_feat for both (two row_dot calls measured ~6% slower).
template <typename T, int W>
__device__ __forceinline__ void row_dot2(const T* a, const T* b, const float* gf, int c1,
                                         float& da, float& db) {
  constexpr int kN = W / sizeof(T);
  float x = 0.f, y = 0.f;
  for (int c = 0; c < c1; c += kN) {
    const auto ra = *reinterpret_cast<const typename Bits<W>::type*>(a + c);
    const auto rb = *reinterpret_cast<const typename Bits<W>::type*>(b + c);
    T ea[kN], eb[kN];
    memcpy(ea, &ra, W);
    memcpy(eb, &rb, W);
#pragma unroll
    for (int q = 0; q < kN; ++q) {
      x = fmaf(gf[c + q], to_f32(ea[q]), x);
      y = fmaf(gf[c + q], to_f32(eb[q]), y);
    }
  }
  da = x;
  db = y;
}

// Shared memory of the staged double backward: the mbarrier; the stage
// (depths, noise, values, gg; the gradient rows overlay the values as they
// are read); g_feat, 0 from column C on; the two passes' per-warp totals
// (8 floats a warp) and the votes (an int a warp); then by input index
// (S + 1: the vector pass may read one past) dM/dsigma, g_feat . f_i -> c',
// g_feat . gg_f_i -> w'; the sorted depths, which the vector pass's per-warp
// channel partials overlay; the input index of each sorted position (S bytes).
__host__ __device__ __forceinline__ int dbl_partial_floats(const Plan& p, int S, int channels) {
  const int part = kWarps * p.unit_rows * channels;
  return part > S ? part : S;
}
int dbl_smem_bytes(const Plan& p, int S, int channels) {
  const int floats =
      round_up(channels, 4) + 9 * kWarps + 3 * (S + 1) + dbl_partial_floats(p, S, channels);
  return kHeaderBytes + p.stride + 4 * floats + S;
}

template <typename T, bool kRelu>
__global__ void __launch_bounds__(kThreads, kDblMinBlocks)
    sort_integrate_double_backward_kernel(const __grid_constant__ DblArgs<T> a) {
  constexpr int kEpv = 16 / sizeof(T);  // values per 16-byte vector
  extern __shared__ __align__(128) unsigned char smem[];
  const Args<T>& f = a.f;
  const Plan& pl = f.plan;
  const int s_a = f.s_a, s_b = f.s_b, S = s_a + s_b;
  const int c1 = f.channels, C = c1 - 1, C4 = (c1 + 3) & ~3;
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem);
  unsigned char* stage = smem + kHeaderBytes;
  const float* zst = reinterpret_cast<const float*>(stage);  // depths, noise
  T* vst = reinterpret_cast<T*>(stage + pl.vals_off);      // value rows, then gradient rows
  const T* gst = reinterpret_cast<const T*>(stage + pl.gg_off);  // gg rows
  float* gf = reinterpret_cast<float*>(stage + pl.stride);
  float* red = gf + C4;  // per-warp totals: -x, v | L w, U w + c L, w, c, c z | sum(g_feat)
  int* vote = reinterpret_cast<int*>(red + 8 * kWarps);
  float* dsg = reinterpret_cast<float*>(vote + kWarps);  // dM/dsigma
  float* cp = dsg + S + 1;                               // g_feat . f_i, then c'
  float* wp = cp + S + 1;                                // g_feat . gg_f_i, then w'
  float* zs = wp + S + 1;  // depth by sorted position, then the channel partials
  float* part = zs;
  uint8_t* src = reinterpret_cast<uint8_t*>(zs + dbl_partial_floats(pl, S, c1));

  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int ni = (S + kThreads - 1) / kThreads;  // sorted positions per thread, contiguous
  int W = 16;  // the dots read the widest chunk that divides a row
  while ((c1 * static_cast<int>(sizeof(T))) % W) W >>= 1;

  // The vector pass (the forward's): this lane's vector within a unit and
  // the columns of its values. A warp holds gpw groups of V lanes; group g
  // takes units g, g + G, ...
  const int V = pl.unit_vecs;
  const int gpw = 32 / V;
  const int G = kWarps * gpw;
  const int unit_elems = pl.unit_rows * c1;
  const bool vlane = lane < gpw * V;
  const int grp = warp * gpw + lane / V;
  const int f0 = (lane % V) * kEpv;  // first element of this lane's vector in a unit
  const int ro_lo = f0 / c1;
  unsigned hi_mask = 0;  // elements of the vector that lie in row ro_lo + 1
#pragma unroll
  for (int e = 0; e < kEpv; ++e) hi_mask |= static_cast<unsigned>((f0 + e) / c1 - ro_lo) << e;
  const int n_units = S / pl.unit_rows;  // each half is whole units

  for (int c = C + t; c < C4; c += kThreads) gf[c] = 0.f;
  if (t == 0) {  // the grid has at most one block per ray
    mbar_init(bar);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    issue_ray<T, true>(f, blockIdx.x, stage, bar, a.gg_a, a.gg_b);
  }
  __syncthreads();

  // The cotangents and |ray_d| of a ray, loaded one ray ahead.
  float pf_gf[kChans], pf_gd, pf_gw, pf_norm;
  auto prefetch = [&](int r) {
#pragma unroll
    for (int q = 0; q < kChans; ++q) {
      const int c = t + kThreads * q;
      pf_gf[q] = c < C ? a.g_feat[static_cast<size_t>(r) * C + c] : 0.f;
    }
    pf_gd = a.g_depth[r];
    pf_gw = a.g_wsum[r];
    pf_norm = f.ray_norm[r];
  };
  prefetch(blockIdx.x);

  int it = 0;
  for (int ray = blockIdx.x; ray < f.n_rays; ray += gridDim.x, ++it) {
    const size_t rs = ray;
    const float gd = pf_gd, gws = pf_gw, norm = pf_norm;
    float gpart = 0.f;
#pragma unroll
    for (int q = 0; q < kChans; ++q) {
      const int c = t + kThreads * q;
      if (c < C) gf[c] = pf_gf[q];
      gpart += pf_gf[q];
    }
    const int next = ray + gridDim.x;
    if (next < f.n_rays) prefetch(next);
    mbar_wait(bar, it & 1);

    // 1. Input sample i = k * kThreads + t: its depth; whether each half is
    // sorted (a vote), and sum(g_feat) (the white_back term), per warp.
    float zi[kItems];
    bool ok_a = true, ok_b = true;
#pragma unroll
    for (int k = 0; k < kItems; ++k) {
      const int i = k * kThreads + t;
      zi[k] = 0.f;
      if (i < S) {
        const bool in_a = i < s_a;
        const int zo = in_a ? i : pl.zb_off + i - s_a;
        zi[k] = zst[zo];
        if (in_a && i + 1 < s_a) ok_a &= zi[k] <= zst[zo + 1];
        if (!in_a && i + 1 < S) ok_b &= zi[k] <= zst[zo + 1];
      }
    }
    ok_a = __all_sync(kFull, ok_a);
    ok_b = __all_sync(kFull, ok_b);
    gpart = warp_allsum(gpart);
    if (lane == 0) {
      vote[warp] = static_cast<int>(ok_a) | (static_cast<int>(ok_b) << 1);
      red[7 * kWarps + warp] = gpart;
    }
    __syncthreads();  // g_feat, the votes
    int votes = 3;
    float gsum = 0.f;
    for (int v = 0; v < kWarps; ++v) {
      votes &= vote[v];
      gsum += red[7 * kWarps + v];
    }

    // 2. The two dots of the thread's own rows, from the stage; the stable
    // rank, the sorted depths and the input index of each position.
#pragma unroll
    for (int k = 0; k < kItems; ++k) {
      const int i = k * kThreads + t;
      if (i < S) {
        const T* vr = vst + static_cast<size_t>(i) * c1;
        const T* gr = gst + static_cast<size_t>(i) * c1;
        if (W == 16) row_dot2<T, 16>(vr, gr, gf, c1, cp[i], wp[i]);
        else if (W == 8) row_dot2<T, 8>(vr, gr, gf, c1, cp[i], wp[i]);
        else if (W == 4) row_dot2<T, 4>(vr, gr, gf, c1, cp[i], wp[i]);
        else row_dot2<T, sizeof(T)>(vr, gr, gf, c1, cp[i], wp[i]);
      }
    }
    int rank[kItems];
    rank_items(zst, s_a, votes & 1, zst + pl.zb_off, s_b, votes & 2, zi, rank);
#pragma unroll
    for (int k = 0; k < kItems; ++k) {
      const int i = k * kThreads + t;
      if (i < S) {
        zs[rank[k]] = zi[k];
        src[rank[k]] = static_cast<uint8_t>(i);
      }
    }
    __syncthreads();

    // 3. Position k = t * ni + m: the forward, L, U, v; the thread's exclusive
    // prefixes of -x and v, then the warp's (pass 1).
    const int il = src[S - 1];
    const float z_last = zs[S - 1];
    const float a_last = cp[il] + gd * z_last + gws;
    const float shift = (f.last_back ? a_last : 0.f) + (f.white_back ? gsum : 0.f);
    const float u_last = f.last_back ? wp[il] : 0.f;
    const float z_shift = f.last_back ? z_last : 0.f;
    float delta[kItems], ex[kItems], d1[kItems], d2[kItems], zk[kItems], L[kItems], U[kItems];
    float v[kItems], gr[kItems], xp[kItems], vp[kItems];
    int ii[kItems];
    float run_x = 0.f, run_v = 0.f;
#pragma unroll
    for (int m = 0; m < kItems; ++m) {
      const int k = t * ni + m;
      delta[m] = d1[m] = d2[m] = zk[m] = L[m] = U[m] = v[m] = gr[m] = 0.f;
      ex[m] = 1.f;
      ii[m] = 0;
      xp[m] = run_x;  // exclusive within the thread, for now
      vp[m] = run_v;
      if (m < ni && k < S) {
        const int i = src[k];
        ii[m] = i;
        float s = to_f32(vst[static_cast<size_t>(i) * c1 + C]);
        if (f.noise) s += zst[pl.noise_off + i];
        if (kRelu) {
          d1[m] = s > 0.f ? 1.f : 0.f;
        } else {
          d1[m] = 1.f / (1.f + expf(-s));
          d2[m] = d1[m] * (1.f - d1[m]);
        }
        zk[m] = zs[k];
        delta[m] = (k == S - 1 ? kLastDelta : zs[k + 1] - zk[m]) * norm;
        const float x = delta[m] * clamp_density<kRelu>(s);
        ex[m] = expf(-x);
        gr[m] = to_f32(gst[static_cast<size_t>(i) * c1 + C]);
        L[m] = cp[i] + gd * zk[m] + gws - shift;
        U[m] = wp[i] - u_last;
        v[m] = gr[m] * delta[m] * d1[m];
        run_x -= x;
        run_v += v[m];
      }
    }
    const float in_x = warp_exclusive_scan(run_x);
    const float in_v = warp_exclusive_scan(run_v);
    if (lane == 31) {
      red[warp] = in_x + run_x;
      red[kWarps + warp] = in_v + run_v;
    }
    __syncthreads();

    // 4. T, T', w, P, c; the exclusive suffixes of L w and U w + c L and the
    // sums of w, c and c (z - z_shift) (pass 2).
    float px = in_x, pv = in_v;
    for (int q = 0; q < warp; ++q) {
      px += red[q];
      pv += red[kWarps + q];
    }
    float tr1[kItems], w[kItems], P[kItems], c[kItems], suf_lw[kItems], suf_x[kItems];
    float sw = 0.f, sc = 0.f, scz = 0.f;
#pragma unroll
    for (int m = 0; m < kItems; ++m) {
      const float tr = expf(px + xp[m]);  // T_k
      tr1[m] = tr * ex[m];                // T'_k
      w[m] = (m < ni && t * ni + m < S) ? (1.f - ex[m]) * tr : 0.f;
      P[m] = pv + vp[m];
      c[m] = v[m] * tr1[m] - w[m] * P[m];
      sw += w[m];
      sc += c[m];
      scz += c[m] * (zk[m] - z_shift);
    }
    float acc_lw = 0.f, acc_x = 0.f;
#pragma unroll
    for (int m = kItems - 1; m >= 0; --m) {
      suf_lw[m] = acc_lw;
      suf_x[m] = acc_x;
      acc_lw += L[m] * w[m];
      acc_x += U[m] * w[m] + c[m] * L[m];
    }
    float tot_lw, tot_x;
    float after_lw = warp_exclusive_suffix(acc_lw, tot_lw);
    float after_x = warp_exclusive_suffix(acc_x, tot_x);
    sw = warp_allsum(sw);
    sc = warp_allsum(sc);
    scz = warp_allsum(scz);
    if (lane == 0) {
      red[2 * kWarps + warp] = tot_lw;
      red[3 * kWarps + warp] = tot_x;
      red[4 * kWarps + warp] = sw;
      red[5 * kWarps + warp] = sc;
      red[6 * kWarps + warp] = scz;
    }
    __syncthreads();
    float w_sum = 0.f, c_sum = 0.f, cz_sum = 0.f;
    for (int q = 0; q < kWarps; ++q) {
      if (q > warp) {
        after_lw += red[2 * kWarps + q];
        after_x += red[3 * kWarps + q];
      }
      w_sum += red[4 * kWarps + q];
      c_sum += red[5 * kWarps + q];
      cz_sum += red[6 * kWarps + q];
    }

    // 5. By input index: w', c', dM/dsigma; dM/dg_depth = sum c'_k z_k and
    // dM/dg_wsum = sum c'_k (0 with last_back: c' moves C_s off the last).
#pragma unroll
    for (int m = 0; m < kItems; ++m) {
      const int k = t * ni + m;
      if (m < ni && k < S) {
        const bool last = k == S - 1;  // its suffixes are empty
        const float D = L[m] * tr1[m] - (last ? 0.f : after_lw + suf_lw[m]);
        const float dx = U[m] * tr1[m] - L[m] * tr1[m] * (P[m] + v[m]) -
                         (last ? 0.f : after_x + suf_x[m]);
        const bool lb = f.last_back && last;
        const int i = ii[m];
        wp[i] = lb ? w[m] + (1.f - w_sum) : w[m];
        cp[i] = lb ? c[m] - c_sum : c[m];
        dsg[i] = dx * delta[m] * d1[m] + D * gr[m] * delta[m] * d2[m];
      }
    }
    if (t == 0) {
      a.d_gdepth[ray] = cz_sum;
      a.d_gwsum[ray] = f.last_back ? 0.f : c_sum;
    }
    __syncthreads();

    // 6. dM/dg_feat and the gradient rows [c'_i g_feat, dM/dsigma_i]: each
    // lane reads its vector of both slabs, adds w' gg + c' f to its channels
    // and writes the gradient of the vector over the values.
    float acc[kEpv];
#pragma unroll
    for (int e = 0; e < kEpv; ++e) acc[e] = 0.f;
    if (vlane) {
      float gfv[kEpv];  // g_feat at this lane's columns, 0 at the sigma column
      unsigned sig_mask = 0;
#pragma unroll
      for (int e = 0; e < kEpv; ++e) {
        const int col = f0 + e - (ro_lo + static_cast<int>((hi_mask >> e) & 1u)) * c1;
        gfv[e] = gf[col];
        sig_mask |= static_cast<unsigned>(col == C) << e;
      }
      unsigned char* vbase = stage + pl.vals_off + f0 * sizeof(T);
      const unsigned char* gbase = stage + pl.gg_off + f0 * sizeof(T);
#pragma unroll 2
      for (int u = grp; u < n_units; u += G) {
        const int row = u * pl.unit_rows + ro_lo;
        const float c_lo = cp[row], c_hi = cp[row + 1], w_lo = wp[row], w_hi = wp[row + 1];
        const float s_lo = dsg[row], s_hi = dsg[row + 1];
        const size_t off = static_cast<size_t>(u) * unit_elems * sizeof(T);
        uint4* vv = reinterpret_cast<uint4*>(vbase + off);
        float x[kEpv], g[kEpv], o[kEpv];
        unpack(*vv, x);
        unpack(*reinterpret_cast<const uint4*>(gbase + off), g);
#pragma unroll
        for (int e = 0; e < kEpv; ++e) {
          const bool hi = (hi_mask >> e) & 1u;
          const float ce = hi ? c_hi : c_lo;
          acc[e] = fmaf(hi ? w_hi : w_lo, g[e], fmaf(ce, x[e], acc[e]));
          o[e] = (sig_mask >> e) & 1u ? (hi ? s_hi : s_lo) : ce * gfv[e];
        }
        *vv = pack(o);
      }
    }
    // Fold the warp's groups onto its first V lanes (same vector position);
    // the partials overlay the sorted depths, read by now.
    float own[kEpv];
#pragma unroll
    for (int e = 0; e < kEpv; ++e) own[e] = acc[e];
    for (int g = 1; g < gpw; ++g) {
#pragma unroll
      for (int e = 0; e < kEpv; ++e) acc[e] += __shfl_down_sync(kFull, own[e], g * V);
    }
    if (lane < V) {
#pragma unroll
      for (int e = 0; e < kEpv; ++e) part[warp * unit_elems + f0 + e] = acc[e];
    }
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");  // the rows, to the bulk store
    __syncthreads();

    // 7. One thread sends each half's gradient slab and, once the stores have
    // read the stage, refills it with the next ray; the partials fold across
    // the warps in a fixed order.
    if (t == 0) {
      const uint32_t rb = c1 * sizeof(T);
      bulk_store(a.d_a + rs * s_a * c1, vst, s_a * rb);
      bulk_store(a.d_b + rs * s_b * c1, vst + static_cast<size_t>(s_a) * c1, s_b * rb);
      bulk_commit();
    }
    const float white = f.white_back ? c_sum : 0.f;
    for (int col = t; col < C; col += kThreads) {
      float sum = 0.f;
      for (int q = 0; q < kWarps; ++q)
        for (int ro = 0; ro < pl.unit_rows; ++ro) sum += part[q * unit_elems + ro * c1 + col];
      a.d_gfeat[rs * C + col] = sum - white;
    }
    if (t == 0 && next < f.n_rays) {
      bulk_wait_read();
      issue_ray<T, true>(f, next, stage, bar, a.gg_a, a.gg_b);
    }
  }
  if (t == 0) bulk_wait();  // the last slabs are written before the block ends
}

// The streamed plan: the first design. Block-wide (kDbThreads) scans and
// sums; every thread calls them, and `red` (kDbWarps floats) is free again
// when they return.
__device__ __forceinline__ float db_excl_prefix(float v, float* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  float incl = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const float n = __shfl_up_sync(kFull, incl, o);
    if (lane >= o) incl += n;
  }
  if (lane == 31) red[warp] = incl;
  __syncthreads();
  float off = 0.f;
  for (int w = 0; w < warp; ++w) off += red[w];
  __syncthreads();
  const float ex = __shfl_up_sync(kFull, incl, 1);
  return off + (lane == 0 ? 0.f : ex);
}

__device__ __forceinline__ float db_excl_suffix(float v, float* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  float incl = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const float n = __shfl_down_sync(kFull, incl, o);
    if (lane + o < 32) incl += n;
  }
  if (lane == 0) red[warp] = incl;
  __syncthreads();
  float off = 0.f;
  for (int w = kDbWarps - 1; w > warp; --w) off += red[w];
  __syncthreads();
  const float ex = __shfl_down_sync(kFull, incl, 1);
  return off + (lane == 31 ? 0.f : ex);
}

__device__ __forceinline__ float db_sum(float v, float* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  v = warp_allsum(v);
  if (lane == 0) red[warp] = v;
  __syncthreads();
  float s = 0.f;
  for (int w = 0; w < kDbWarps; ++w) s += red[w];
  __syncthreads();
  return s;
}

// Shared memory of the streamed plan, in floats: by input index the depths,
// dots, sigma + noise, gg's sigma column, w', c', dM/ds; the sorted depths;
// g_feat; the block sums; then the input index of each sorted position (ints).
int dbl_streamed_smem_bytes(int S, int channels) { return 4 * (10 * S + channels + kDbWarps); }

template <typename T, bool kRelu>
__global__ void __launch_bounds__(kDbThreads)
    sort_integrate_double_backward_streamed_kernel(const __grid_constant__ DblArgs<T> a) {
  extern __shared__ __align__(16) float dsm[];
  const Args<T>& f = a.f;
  const int s_a = f.s_a, s_b = f.s_b, S = s_a + s_b;
  const int c1 = f.channels, C = c1 - 1;
  float* zin = dsm;         // depth by input index
  float* dotf = zin + S;    // g_feat . f_i
  float* dotg = dotf + S;   // g_feat . gg_f_i
  float* sg = dotg + S;     // sigma + noise
  float* ggr = sg + S;      // gg's sigma column
  float* wp = ggr + S;      // w'
  float* cp = wp + S;       // c'
  float* dsg = cp + S;      // dM/dsigma
  float* zs = dsg + S;      // depth by sorted position
  float* gf = zs + S;       // g_feat (C)
  float* red = gf + c1;     // block sums (kDbWarps)
  int* src = reinterpret_cast<int*>(red + kDbWarps);  // input index by position
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;

  for (int ray = blockIdx.x; ray < f.n_rays; ray += gridDim.x) {
    const size_t rs = ray;
    const float norm = f.ray_norm[ray], gd = a.g_depth[ray], gw = a.g_wsum[ray];

    // 1. Input sample t: depth, sigma + noise, gg's sigma column; g_feat.
    if (t < S) {
      const bool in_a = t < s_a;
      const size_t row = in_a ? rs * s_a + t : rs * s_b + (t - s_a);
      zin[t] = in_a ? f.z_a[row] : f.z_b[row];
      float s = to_f32((in_a ? f.v_a : f.v_b)[row * c1 + C]);
      if (f.noise) s += f.noise[rs * S + t];
      sg[t] = s;
      ggr[t] = to_f32((in_a ? a.gg_a : a.gg_b)[row * c1 + C]);
    }
    for (int c = t; c < C; c += kDbThreads) gf[c] = a.g_feat[rs * C + c];
    __syncthreads();

    // 2. g_feat . f_i and g_feat . gg_f_i, a warp a row.
    for (int i = warp; i < S; i += kDbWarps) {
      const bool in_a = i < s_a;
      const size_t row = in_a ? rs * s_a + i : rs * s_b + (i - s_a);
      const T* vr = (in_a ? f.v_a : f.v_b) + row * c1;
      const T* gr = (in_a ? a.gg_a : a.gg_b) + row * c1;
      float af = 0.f, ag = 0.f;
      for (int c = lane; c < C; c += 32) {
        af = fmaf(gf[c], to_f32(vr[c]), af);
        ag = fmaf(gf[c], to_f32(gr[c]), ag);
      }
      af = warp_allsum(af);
      ag = warp_allsum(ag);
      if (lane == 0) {
        dotf[i] = af;
        dotg[i] = ag;
      }
    }

    // 3. The forward's stable rank (the first half before the second on
    // ties), by counting; the sorted depths and the input index by position.
    if (t < S) {
      const float zi = zin[t];
      int rank = 0;
      for (int j = 0; j < S; ++j) rank += before(zin[j], j, zi, t);
      zs[rank] = zi;
      src[rank] = t;
    }
    const float gsum = db_sum(t < C ? gf[t] : 0.f, red);  // sum(g_feat); also the barrier

    // 4. Position k = t: the forward, the backward's D_k, then M's terms.
    const int k = t;
    const bool on = k < S;
    const int i = on ? src[k] : 0;
    float d1 = 0.f, d2 = 0.f, delta = 0.f, x = 0.f, e = 1.f, zk = 0.f;
    if (on) {
      const float s = sg[i];
      const float d = clamp_density<kRelu>(s);
      if (kRelu) {
        d1 = s > 0.f ? 1.f : 0.f;
      } else {
        d1 = 1.f / (1.f + expf(-s));
        d2 = d1 * (1.f - d1);
      }
      zk = zs[k];
      delta = (k == S - 1 ? kLastDelta : zs[k + 1] - zk) * norm;
      x = delta * d;
      e = expf(-x);
    }
    const float tr = expf(db_excl_prefix(-x, red));  // T_k
    const float tr1 = tr * e;                         // T'_k
    const float w = on ? (1.f - e) * tr : 0.f;
    const float W = db_sum(w, red);
    const int il = src[S - 1];
    const float a_last = dotf[il] + gd * zs[S - 1] + gw;
    const float shift = (f.last_back ? a_last : 0.f) + (f.white_back ? gsum : 0.f);
    const float L = on ? dotf[i] + gd * zk + gw - shift : 0.f;
    const float D = L * tr1 - db_excl_suffix(L * w, red);
    const float U = on ? dotg[i] - (f.last_back ? dotg[il] : 0.f) : 0.f;
    const float v = on ? ggr[i] * delta * d1 : 0.f;
    const float P = db_excl_prefix(v, red);
    const float c = v * tr1 - w * P;
    const float Cs = db_sum(c, red);
    const bool last = f.last_back && k == S - 1;
    const float cpk = c - (last ? Cs : 0.f);
    const float dx = U * tr1 - L * tr1 * (P + v) - db_excl_suffix(U * w + c * L, red);
    if (on) {
      wp[i] = w + (last ? 1.f - W : 0.f);
      cp[i] = cpk;
      dsg[i] = dx * delta * d1 + D * ggr[i] * delta * d2;
    }
    const float dgd = db_sum(on ? cpk * zk : 0.f, red);  // also the barrier for wp, cp, dsg
    const float dgw = db_sum(cpk, red);
    if (t == 0) {
      a.d_gdepth[ray] = dgd;
      a.d_gwsum[ray] = dgw;
    }

    // 5. The value rows [c'_i g_feat, dM/dsigma_i], flat and coalesced.
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int first = h ? s_a : 0;
      const int n = (h ? s_b : s_a) * c1;
      T* out = h ? a.d_b + rs * s_b * c1 : a.d_a + rs * s_a * c1;
      for (int q = t; q < n; q += kDbThreads) {
        const int r = q / c1, col = q - r * c1;
        const int ii = first + r;
        out[q] = from_f32<T>(col < C ? cp[ii] * gf[col] : dsg[ii]);
      }
    }

    // 6. dM/dg_feat, a thread a channel, over the rows in input order.
    for (int col = t; col < C; col += kDbThreads) {
      float acc = 0.f;
      for (int ii = 0; ii < S; ++ii) {
        const bool in_a = ii < s_a;
        const size_t row = in_a ? rs * s_a + ii : rs * s_b + (ii - s_a);
        const size_t o = row * c1 + col;
        acc = fmaf(wp[ii], to_f32((in_a ? a.gg_a : a.gg_b)[o]), acc);
        acc = fmaf(cp[ii], to_f32((in_a ? f.v_a : f.v_b)[o]), acc);
      }
      a.d_gfeat[rs * C + col] = acc - (f.white_back ? Cs : 0.f);
    }
    __syncthreads();  // the next ray overwrites the shared arrays
  }
}

// Blocks of a persistent launch of `threads` a block: as many as fit on the
// card at once, at most one a ray. `set_smem` and `blocks_per_sm` keep the
// kernel's attribute and occupancy for the shared-memory size of its last
// launch.
int persistent_grid(const void* kernel, int threads, int smem, int n_rays, int device,
                    int& set_smem, int& blocks_per_sm, int& grid) {
  cudaError_t err;
  if (smem != set_smem) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks_per_sm, kernel, threads, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    set_smem = smem;
  }
  if (blocks_per_sm < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
  int sms = 0;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return static_cast<int>(err);
  grid = n_rays < blocks_per_sm * sms ? n_rays : blocks_per_sm * sms;
  return 0;
}

template <typename T, bool kRelu>
int launch(int device, const Args<T>& a, cudaStream_t st) {
  static int set_smem = -1, blocks_per_sm = 0;  // per instantiation
  auto* kernel = sort_integrate_kernel<T, kRelu>;
  const int smem = smem_bytes(a.plan, a.s_a + a.s_b);
  int grid = 0;
  const int err = persistent_grid(reinterpret_cast<const void*>(kernel), kThreads, smem, a.n_rays,
                                  device, set_smem, blocks_per_sm, grid);
  if (err) return err;
  kernel<<<grid, kThreads, smem, st>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, bool kRelu>
int launch_backward(int device, const BwdArgs<T>& a, cudaStream_t st) {
  static int set_smem = -1, blocks_per_sm = 0;  // per instantiation
  auto* kernel = sort_integrate_backward_kernel<T, kRelu>;
  const int smem = bwd_smem_bytes(a.f.plan, a.f.s_a + a.f.s_b, a.f.channels);
  int grid = 0;
  const int err = persistent_grid(reinterpret_cast<const void*>(kernel), kThreads, smem,
                                  a.f.n_rays, device, set_smem, blocks_per_sm, grid);
  if (err) return err;
  kernel<<<grid, kThreads, smem, st>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, bool kRelu>
int launch_double_backward(int device, const DblArgs<T>& a, cudaStream_t st) {
  const int S = a.f.s_a + a.f.s_b;
  int grid = 0, err;
  if (a.f.plan.staged) {
    static int set_smem = -1, blocks_per_sm = 0;  // per instantiation
    auto* kernel = sort_integrate_double_backward_kernel<T, kRelu>;
    const int smem = dbl_smem_bytes(a.f.plan, S, a.f.channels);
    err = persistent_grid(reinterpret_cast<const void*>(kernel), kThreads, smem, a.f.n_rays,
                          device, set_smem, blocks_per_sm, grid);
    if (err) return err;
    kernel<<<grid, kThreads, smem, st>>>(a);
  } else {
    static int set_smem = -1, blocks_per_sm = 0;
    auto* kernel = sort_integrate_double_backward_streamed_kernel<T, kRelu>;
    const int smem = dbl_streamed_smem_bytes(S, a.f.channels);
    err = persistent_grid(reinterpret_cast<const void*>(kernel), kDbThreads, smem, a.f.n_rays,
                          device, set_smem, blocks_per_sm, grid);
    if (err) return err;
    kernel<<<grid, kDbThreads, smem, st>>>(a);
  }
  return static_cast<int>(cudaGetLastError());
}

// The forward's inputs and launch plan. `gg_a` and `gg_b` are the double
// backward's second slabs, staged beside the values, or null; `out_a` and
// `out_b` are outputs the plan also needs 16-byte aligned (the gradients), or
// null.
template <typename T>
Args<T> make_args(const void* z_a, const void* v_a, int s_a, const void* z_b, const void* v_b,
                  int s_b, const void* ray_norm, const void* noise, int n_rays, int channels,
                  int last_back, int white_back, const void* gg_a, const void* gg_b,
                  const void* out_a, const void* out_b) {
  Args<T> a{};
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
  const void* copied[] = {z_a, v_a, z_b, v_b, noise, gg_a, gg_b, out_a, out_b};  // null is aligned
  bool aligned = true;  // the bulk copies and the vector writes need 16-byte-aligned addresses
  for (const void* p : copied) aligned &= (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
  const bool gg = gg_a != nullptr;
  a.plan = make_plan(s_a, s_b, channels, sizeof(T), noise != nullptr, gg, aligned,
                     gg ? kMaxDblStageBytes : kMaxStageBytes);
  return a;
}

template <typename T>
int dispatch(int device, const void* z_a, const void* v_a, int s_a, const void* z_b,
             const void* v_b, int s_b, const void* ray_norm, const void* noise, int n_rays,
             int channels, int relu, int last_back, int white_back, void* feat, void* depth,
             void* wsum, cudaStream_t st) {
  Args<T> a = make_args<T>(z_a, v_a, s_a, z_b, v_b, s_b, ray_norm, noise, n_rays, channels,
                           last_back, white_back, nullptr, nullptr, nullptr, nullptr);
  a.feat = static_cast<float*>(feat);
  a.depth = static_cast<float*>(depth);
  a.wsum = static_cast<float*>(wsum);
  return relu ? launch<T, true>(device, a, st) : launch<T, false>(device, a, st);
}

template <typename T>
int dispatch_backward(int device, const void* z_a, const void* v_a, int s_a, const void* z_b,
                      const void* v_b, int s_b, const void* ray_norm, const void* noise,
                      int n_rays, int channels, int relu, int last_back, int white_back,
                      const void* g_feat, const void* g_depth, const void* g_wsum, void* gv_a,
                      void* gv_b, cudaStream_t st) {
  BwdArgs<T> a;
  a.f = make_args<T>(z_a, v_a, s_a, z_b, v_b, s_b, ray_norm, noise, n_rays, channels, last_back,
                     white_back, nullptr, nullptr, gv_a, gv_b);
  a.g_feat = static_cast<const float*>(g_feat);
  a.g_depth = static_cast<const float*>(g_depth);
  a.g_wsum = static_cast<const float*>(g_wsum);
  a.gv_a = static_cast<T*>(gv_a);
  a.gv_b = static_cast<T*>(gv_b);
  return relu ? launch_backward<T, true>(device, a, st) : launch_backward<T, false>(device, a, st);
}

template <typename T>
int dispatch_double_backward(int device, const void* z_a, const void* v_a, int s_a,
                             const void* z_b, const void* v_b, int s_b, const void* ray_norm,
                             const void* noise, int n_rays, int channels, int relu, int last_back,
                             int white_back, const void* g_feat, const void* g_depth,
                             const void* g_wsum, const void* gg_a, const void* gg_b, void* d_a,
                             void* d_b, void* d_gfeat, void* d_gdepth, void* d_gwsum,
                             cudaStream_t st) {
  DblArgs<T> a;
  a.f = make_args<T>(z_a, v_a, s_a, z_b, v_b, s_b, ray_norm, noise, n_rays, channels, last_back,
                     white_back, gg_a, gg_b, d_a, d_b);
  a.g_feat = static_cast<const float*>(g_feat);
  a.g_depth = static_cast<const float*>(g_depth);
  a.g_wsum = static_cast<const float*>(g_wsum);
  a.gg_a = static_cast<const T*>(gg_a);
  a.gg_b = static_cast<const T*>(gg_b);
  a.d_a = static_cast<T*>(d_a);
  a.d_b = static_cast<T*>(d_b);
  a.d_gfeat = static_cast<float*>(d_gfeat);
  a.d_gdepth = static_cast<float*>(d_gdepth);
  a.d_gwsum = static_cast<float*>(d_gwsum);
  return relu ? launch_double_backward<T, true>(device, a, st)
              : launch_double_backward<T, false>(device, a, st);
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

// K1's backward: writes grad_vals_a [n_rays, s_a, channels] and grad_vals_b in
// the values' dtype from fp32 cotangents g_feat [n_rays, channels - 1], g_depth
// and g_wsum [n_rays]. Same conventions as the forward.
extern "C" int ide3d_sort_integrate_backward(
    int device, const void* z_a, const void* v_a, int s_a, const void* z_b, const void* v_b,
    int s_b, const void* ray_norm, const void* noise, int n_rays, int channels, int vals_bf16,
    int relu, int last_back, int white_back, const void* g_feat, const void* g_depth,
    const void* g_wsum, void* gv_a, void* gv_b, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const auto st = static_cast<cudaStream_t>(stream);
  if (vals_bf16)
    return dispatch_backward<__nv_bfloat16>(device, z_a, v_a, s_a, z_b, v_b, s_b, ray_norm,
                                            noise, n_rays, channels, relu, last_back,
                                            white_back, g_feat, g_depth, g_wsum, gv_a, gv_b, st);
  return dispatch_backward<float>(device, z_a, v_a, s_a, z_b, v_b, s_b, ray_norm, noise, n_rays,
                                  channels, relu, last_back, white_back, g_feat, g_depth, g_wsum,
                                  gv_a, gv_b, st);
}

// K1's double backward: from the backward's inputs and the cotangents gg_a,
// gg_b of its two gradients (the values' dtype and shape), writes the
// gradients of the values d_a, d_b (their dtype) and of the cotangents
// d_gfeat [n_rays, channels - 1], d_gdepth and d_gwsum [n_rays] (fp32). Same
// conventions as the forward.
extern "C" int ide3d_sort_integrate_double_backward(
    int device, const void* z_a, const void* v_a, int s_a, const void* z_b, const void* v_b,
    int s_b, const void* ray_norm, const void* noise, int n_rays, int channels, int vals_bf16,
    int relu, int last_back, int white_back, const void* g_feat, const void* g_depth,
    const void* g_wsum, const void* gg_a, const void* gg_b, void* d_a, void* d_b, void* d_gfeat,
    void* d_gdepth, void* d_gwsum, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const auto st = static_cast<cudaStream_t>(stream);
  if (vals_bf16)
    return dispatch_double_backward<__nv_bfloat16>(
        device, z_a, v_a, s_a, z_b, v_b, s_b, ray_norm, noise, n_rays, channels, relu, last_back,
        white_back, g_feat, g_depth, g_wsum, gg_a, gg_b, d_a, d_b, d_gfeat, d_gdepth, d_gwsum, st);
  return dispatch_double_backward<float>(
      device, z_a, v_a, s_a, z_b, v_b, s_b, ray_norm, noise, n_rays, channels, relu, last_back,
      white_back, g_feat, g_depth, g_wsum, gg_a, gg_b, d_a, d_b, d_gfeat, d_gdepth, d_gwsum, st);
}

// The double backward's launch plan for these shapes and pointers (the
// outputs taken as 16-byte aligned, as the wrapper's allocations are): 1
// staged, 0 streamed.
extern "C" int ide3d_sort_integrate_double_backward_plan(
    const void* z_a, const void* v_a, int s_a, const void* z_b, const void* v_b, int s_b,
    const void* noise, int channels, int vals_bf16, const void* gg_a, const void* gg_b) {
  const Plan p = vals_bf16
      ? make_args<__nv_bfloat16>(z_a, v_a, s_a, z_b, v_b, s_b, nullptr, noise, 0, channels, 0, 0,
                                 gg_a, gg_b, nullptr, nullptr).plan
      : make_args<float>(z_a, v_a, s_a, z_b, v_b, s_b, nullptr, noise, 0, channels, 0, 0, gg_a,
                         gg_b, nullptr, nullptr).plan;
  return p.staged;
}
