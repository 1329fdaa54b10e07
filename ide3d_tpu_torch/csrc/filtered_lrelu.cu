// The filtered leaky ReLU of the StyleGAN3 alias-free layer, fused into one
// pass over the image: bias -> FIR upsample by UP (gain UP^2) -> leaky ReLU,
// gain and clamp -> FIR downsample by DOWN.
//
// Replaces no TPU kernel: the JAX package computes `filtered_lrelu`
// (ide3d_tpu/ops/filtered_lrelu.py) as XLA convolutions, and the port's plain
// version (ops/filtered_lrelu.filtered_lrelu) as PyTorch's depthwise
// convolutions over the zero-stuffed grid. It is the fused op the published
// layer calls (NVlabs/stylegan3 torch_utils/ops/filtered_lrelu.cu), written
// anew for the SG3 superres stack of models/generator.py.
//
// Semantics, as the plain version: x [N, C, H, W] plus the bias; zero
// insertion by UP; padding (px0, px1, py0, py1) taken w.r.t. the upsampled
// image (negative crops); the separable filter fu (TU taps, gain UP a pass,
// flipped for a true convolution unless flip_filter); the leaky ReLU
// (x > 0 ? x : slope x), times gain, clamped to +-clamp (clamp < 0: none); the
// separable filter fd (TD taps, no padding); every DOWN-th pixel from the
// first. A filter of 1 tap (absent) is [1]. Sums are fp32; x, the bias and
// the output are fp32 or bf16, the output rounded once (to nearest even).
//
// Bound on the H100: at the SG3 stack's shapes (B = 8, 9 calls a frame) the
// op must move 1.07 GB, 0.32 ms at 3.35 TB/s, and do 44 GFLOP of polyphase
// multiply-adds, 0.66 ms at the 67 TFLOP/s fp32 rate of the CUDA cores. So
// the arithmetic bounds it; the plain version, which writes the upsampled
// grid (1034^2 a plane at 512^2) several times over and multiplies zeros,
// is ~100x slower.
//
// Design: one 256-thread block an output tile of TO x TO pixels of one plane
// (TO = 32; 16 for UP = 1, whose footprint is wider). The upsampled grid never
// reaches device memory:
//   0. the tile's input footprint (NIN^2 pixels, bias added, zeros outside
//      the image) is read once into shared memory as fp32;
//   1. rows up: the polyphase up filter along x, NIN rows x TYP columns of the
//      intermediate grid, each output from TU / UP taps (no multiply by an
//      inserted zero);
//   2. columns up, then the activation: TYP x TYP intermediate pixels;
//   3. rows down: TY rows x TO columns, TD taps each;
//   4. columns down, and the store of TO x TO outputs in the input's dtype.
// Each thread computes K = 4 outputs of a pass from registers (the K + taps - 1
// inputs loaded once), so a shared-memory load feeds ~2.7 multiply-adds; in a
// pass along x consecutive threads take consecutive rows and every row pitch
// is odd, so a warp's loads fall in 32 banks. Stages 0 and 2 share a buffer,
// stages 1 and 3 another: 40 KB of shared memory a block at (UP, DOWN) =
// (2, 2), 35 KB at (4, 2), so 5 and 6 blocks (1280 and 1536 threads) are
// resident per SM; the grid is N x C x tiles, ~65k blocks for a 512^2 layer of
// the stack. The intermediate grid has a halo of TD - DOWN pixels a side per
// tile: 1.34x the multiply-adds of the exact polyphase count at (2, 2).
// Without filters and at UP = DOWN = 1 (the ToRGB layer), a grid-stride
// elementwise kernel adds the bias and clamps.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kPerThread = 4;  // K: outputs a thread computes in a pass

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void put(float* p, float v) { *p = v; }
__device__ __forceinline__ void put(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }

__device__ __forceinline__ float activate(float v, float gain, float slope, float clamp) {
  v = (v > 0.f ? v : v * slope) * gain;
  if (clamp >= 0.f) v = v < -clamp ? -clamp : (v > clamp ? clamp : v);  // NaN stays NaN
  return v;
}

__device__ __forceinline__ int floor_div(int a, int b) { return a >= 0 ? a / b : -((-a + b - 1) / b); }

constexpr int round_up(int a, int b) { return (a + b - 1) / b * b; }
constexpr int cmax(int a, int b) { return a > b ? a : b; }

template <int UP, int DOWN, int TU, int TD>
struct Tile {
  static constexpr int K = kPerThread;
  static constexpr int TO = UP == 1 ? 16 : 32;           // output tile side
  static constexpr int NTU = (TU + UP - 1) / UP;          // up-filter taps a phase
  static constexpr int TY = (TO - 1) * DOWN + TD;         // intermediate side the tile reads
  static constexpr int TYP = round_up(TY, UP * K);        // ... in whole thread groups
  static constexpr int NIN = (TYP + 2 * UP - 2) / UP + NTU;  // input footprint side
  static constexpr int PIN = NIN | 1;                     // odd row pitches
  static constexpr int PY = TYP | 1;
  static constexpr int PB = TO | 1;
  static constexpr int BUF1 = cmax(NIN * PIN, TYP * PY);  // footprint, then intermediate
  static constexpr int BUF2 = cmax(NIN * PY, TY * PB);    // rows up, then rows down
  static_assert((BUF1 + BUF2 + TU + TD) * 4 <= 48 * 1024, "static shared memory");
  static_assert(TO % K == 0, "whole thread groups a row of the tile");
};

// K outputs of the polyphase up filter on a line `in` (stride si): the outputs
// j = jp + UP (g K + t), t < K, of the intermediate grid, whose first pixel
// lies r0 upsampled pixels after the line's first input. All K share a phase,
// so they share the taps k[i0], k[i0 + UP], ...
template <int UP, int TU>
__device__ __forceinline__ void up_line(const float* in, int si, const float* k, int r0, int jp,
                                        int g, float (&acc)[kPerThread]) {
  constexpr int NTU = (TU + UP - 1) / UP;
  constexpr int K = kPerThread;
  const int s = r0 + jp;
  const int i0 = (UP - s % UP) % UP;
  const int base = (s + i0) / UP + g * K;
  float w[NTU], v[K + NTU - 1];
#pragma unroll
  for (int m = 0; m < NTU; ++m) w[m] = i0 + m * UP < TU ? k[i0 + m * UP] : 0.f;
#pragma unroll
  for (int n = 0; n < K + NTU - 1; ++n) v[n] = in[(base + n) * si];
#pragma unroll
  for (int t = 0; t < K; ++t) {
    float a = 0.f;
#pragma unroll
    for (int m = 0; m < NTU; ++m) a = fmaf(w[m], v[t + m], a);
    acc[t] = a;
  }
}

// K outputs g K + t of the down filter on a line `in` (stride si).
template <int DOWN, int TD>
__device__ __forceinline__ void down_line(const float* in, int si, const float (&w)[TD], int g,
                                          float (&acc)[kPerThread]) {
  constexpr int K = kPerThread;
  float v[(K - 1) * DOWN + TD];
#pragma unroll
  for (int n = 0; n < (K - 1) * DOWN + TD; ++n) v[n] = in[(g * K * DOWN + n) * si];
#pragma unroll
  for (int t = 0; t < K; ++t) {
    float a = 0.f;
#pragma unroll
    for (int i = 0; i < TD; ++i) a = fmaf(w[i], v[t * DOWN + i], a);
    acc[t] = a;
  }
}

template <int UP, int DOWN, int TU, int TD, typename T>
__global__ void __launch_bounds__(kThreads) filtered_lrelu_kernel(
    const T* __restrict__ x, const T* __restrict__ bias, const float* __restrict__ fu,
    const float* __restrict__ fd, T* __restrict__ out, int C, int H, int W, int Ho, int Wo,
    int px0, int py0, int tiles_x, int tiles_y, int flip, float gain, float slope, float clamp) {
  using S = Tile<UP, DOWN, TU, TD>;
  constexpr int K = S::K;
  __shared__ float buf1[S::BUF1];
  __shared__ float buf2[S::BUF2];
  __shared__ float ku[TU];
  __shared__ float kd[TD];

  const int tid = threadIdx.x;
  int blk = blockIdx.x;
  const int tx = blk % tiles_x;
  blk /= tiles_x;
  const int ty = blk % tiles_y;
  const int64_t plane = blk / tiles_y;
  const int ox0 = tx * S::TO, oy0 = ty * S::TO;

  // The filters as correlation taps: flipped unless flip_filter, UP a pass.
  if (tid < TU) ku[tid] = (fu ? fu[flip ? tid : TU - 1 - tid] : 1.f) * UP;
  if (tid < TD) kd[tid] = fd ? fd[flip ? tid : TD - 1 - tid] : 1.f;

  // The tile's first intermediate pixel is upsampled pixel a = o0 DOWN - p0 of
  // the input; input pixel i0 = floor(a / UP) is the footprint's first, r0
  // upsampled pixels before it.
  const int ax = ox0 * DOWN - px0, ay = oy0 * DOWN - py0;
  const int ix0 = floor_div(ax, UP), iy0 = floor_div(ay, UP);
  const int rx = ax - ix0 * UP, ry = ay - iy0 * UP;

  // 0. The footprint, bias added, zeros outside the image.
  float* s_in = buf1;
  {
    const float b = bias ? to_f(bias[plane % C]) : 0.f;
    const T* xp = x + plane * H * W;
    for (int i = tid; i < S::NIN * S::NIN; i += kThreads) {
      const int r = i / S::NIN, q = i - r * S::NIN;
      const int gy = iy0 + r, gx = ix0 + q;
      float v = 0.f;
      if (gy >= 0 && gy < H && gx >= 0 && gx < W) v = to_f(xp[(int64_t)gy * W + gx]) + b;
      s_in[r * S::PIN + q] = v;
    }
  }
  __syncthreads();

  // 1. Rows up: s_a[r][j], one thread a row in turn.
  float* s_a = buf2;
  constexpr int GU = S::TYP / (UP * K);
  for (int i = tid; i < S::NIN * UP * GU; i += kThreads) {
    const int r = i % S::NIN, rest = i / S::NIN;
    const int jp = rest % UP, g = rest / UP;
    float acc[K];
    up_line<UP, TU>(s_in + r * S::PIN, 1, ku, rx, jp, g, acc);
#pragma unroll
    for (int t = 0; t < K; ++t) s_a[r * S::PY + jp + UP * (g * K + t)] = acc[t];
  }
  __syncthreads();

  // 2. Columns up and the activation: s_y[v][j], one thread a column in turn.
  float* s_y = buf1;
  for (int i = tid; i < S::TYP * UP * GU; i += kThreads) {
    const int j = i % S::TYP, rest = i / S::TYP;
    const int vp = rest % UP, g = rest / UP;
    float acc[K];
    up_line<UP, TU>(s_a + j, S::PY, ku, ry, vp, g, acc);
#pragma unroll
    for (int t = 0; t < K; ++t)
      s_y[(vp + UP * (g * K + t)) * S::PY + j] = activate(acc[t], gain, slope, clamp);
  }
  __syncthreads();

  float wd[TD];
#pragma unroll
  for (int i = 0; i < TD; ++i) wd[i] = kd[i];

  // 3. Rows down: s_b[v][o].
  float* s_b = buf2;
  constexpr int GD = S::TO / K;
  for (int i = tid; i < S::TY * GD; i += kThreads) {
    const int v = i % S::TY, g = i / S::TY;
    float acc[K];
    down_line<DOWN, TD>(s_y + v * S::PY, 1, wd, g, acc);
#pragma unroll
    for (int t = 0; t < K; ++t) s_b[v * S::PB + g * K + t] = acc[t];
  }
  __syncthreads();

  // 4. Columns down and the store.
  T* op = out + plane * Ho * Wo;
  for (int i = tid; i < S::TO * GD; i += kThreads) {
    const int o = i % S::TO, g = i / S::TO;
    const int gx = ox0 + o;
    float acc[K];
    down_line<DOWN, TD>(s_b + o, S::PB, wd, g, acc);
#pragma unroll
    for (int t = 0; t < K; ++t) {
      const int gy = oy0 + g * K + t;
      if (gx < Wo && gy < Ho) put(op + (int64_t)gy * Wo + gx, acc[t]);
    }
  }
}

// No filters, UP = DOWN = 1, no padding: the bias, activation, gain and clamp.
template <typename T>
__global__ void __launch_bounds__(kThreads) filtered_lrelu_act_kernel(
    const T* __restrict__ x, const T* __restrict__ bias, T* __restrict__ out, int64_t n, int C,
    int64_t hw, float gain, float slope, float clamp) {
  for (int64_t i = blockIdx.x * (int64_t)kThreads + threadIdx.x; i < n;
       i += (int64_t)gridDim.x * kThreads) {
    const float b = bias ? to_f(bias[(i / hw) % C]) : 0.f;
    put(out + i, activate(to_f(x[i]) + b, gain, slope, clamp));
  }
}

struct Args {
  const void* x;
  const void* bias;
  const float* fu;
  const float* fd;
  void* out;
  int N, C, H, W, Ho, Wo, px0, py0, flip;
  float gain, slope, clamp;
};

template <int UP, int DOWN, int TU, int TD, typename T>
int launch(const Args& a, cudaStream_t st) {
  using S = Tile<UP, DOWN, TU, TD>;
  const int tiles_x = (a.Wo + S::TO - 1) / S::TO, tiles_y = (a.Ho + S::TO - 1) / S::TO;
  const long long blocks = (long long)a.N * a.C * tiles_x * tiles_y;
  if (blocks > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
  if (blocks == 0) return 0;
  filtered_lrelu_kernel<UP, DOWN, TU, TD, T><<<(unsigned)blocks, kThreads, 0, st>>>(
      static_cast<const T*>(a.x), static_cast<const T*>(a.bias), a.fu, a.fd,
      static_cast<T*>(a.out), a.C, a.H, a.W, a.Ho, a.Wo, a.px0, a.py0, tiles_x, tiles_y, a.flip,
      a.gain, a.slope, a.clamp);
  return static_cast<int>(cudaGetLastError());
}

template <int UP, int DOWN, typename T>
int by_taps(const Args& a, int tu, int td, cudaStream_t st) {
  constexpr int FU = 6 * UP, FD = 6 * DOWN;
  if (tu == FU && td == FD) return launch<UP, DOWN, FU, FD, T>(a, st);
  if (tu == FU && td == 1) return launch<UP, DOWN, FU, 1, T>(a, st);
  if (tu == 1 && td == FD) return launch<UP, DOWN, 1, FD, T>(a, st);
  if (tu == 1 && td == 1) {
    if constexpr (UP == 1 && DOWN == 1) return static_cast<int>(cudaErrorInvalidValue);
    else return launch<UP, DOWN, 1, 1, T>(a, st);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

template <typename T>
int dispatch(const Args& a, int up, int down, int tu, int td, cudaStream_t st) {
  if (up == 1 && down == 1 && tu == 1 && td == 1) {
    if (a.Ho != a.H || a.Wo != a.W) return static_cast<int>(cudaErrorInvalidValue);
    const int64_t n = (int64_t)a.N * a.C * a.H * a.W;
    if (n == 0) return 0;
    const int64_t want = (n + kThreads - 1) / kThreads;
    const int blocks = (int)(want < 132 * 32 ? want : 132 * 32);
    filtered_lrelu_act_kernel<T><<<blocks, kThreads, 0, st>>>(
        static_cast<const T*>(a.x), static_cast<const T*>(a.bias), static_cast<T*>(a.out), n, a.C,
        (int64_t)a.H * a.W, a.gain, a.slope, a.clamp);
    return static_cast<int>(cudaGetLastError());
  }
  switch (up * 10 + down) {
    case 11: return by_taps<1, 1, T>(a, tu, td, st);
    case 12: return by_taps<1, 2, T>(a, tu, td, st);
    case 21: return by_taps<2, 1, T>(a, tu, td, st);
    case 22: return by_taps<2, 2, T>(a, tu, td, st);
    case 41: return by_taps<4, 1, T>(a, tu, td, st);
    case 42: return by_taps<4, 2, T>(a, tu, td, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// One filtered_lrelu forward on `stream`: x [N, C, H, W] (bf16 if x_bf16, else
// fp32; the bias [C] of the same dtype or null) -> out [N, C, Ho, Wo], same
// dtype. fu [tu] and fd [td] are fp32 1-D filters, null for one tap; up in
// {1, 2, 4}, down in {1, 2}, each filter 6 x its factor taps or 1. px0 and py0
// are the padding before the image (the sizes give the rest). clamp < 0: no
// clamp. Returns a cudaError_t (0: launched).
extern "C" int ide3d_filtered_lrelu(int device, const void* x, const void* bias, const void* fu,
                                    const void* fd, void* out, int N, int C, int H, int W, int Ho,
                                    int Wo, int up, int down, int tu, int td, int px0, int py0,
                                    int flip, int x_bf16, float gain, float slope, float clamp,
                                    void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const Args a{x, bias, static_cast<const float*>(fu), static_cast<const float*>(fd), out, N, C, H,
               W, Ho, Wo, px0, py0, flip, gain, slope, clamp};
  const auto st = static_cast<cudaStream_t>(stream);
  if (x_bf16) return dispatch<__nv_bfloat16>(a, up, down, tu, td, st);
  return dispatch<float>(a, up, down, tu, td, st);
}
