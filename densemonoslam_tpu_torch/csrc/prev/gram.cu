// Previous design of this kernel, kept only as the yardstick that
// chip_smoke.py times beside the current one in the same run ("prev_ms").
// The port never calls it.
//
// Gram reduction G = M^T M for the tall-skinny row matrices of dense tracking.
//
// Replaces the TPU kernel `densemonoslam_tpu/ops/pallas/gram.py`
// (`gram_pallas`, body `_gram_kernel`), which `reductions.gram` calls in
// every SO3 and Gauss-Newton iteration: M is f32 [P, C] with C = 8 (SO3
// pre-align rows) or C = 16 (joint ICP+RGB rows), P up to ~77k per call.
//
// What bounds it on Hopper: device memory.  One row is C*4 bytes and feeds
// C*C multiply-adds; at C = 8 that is 64 multiply-adds per 32-byte row
// (~4 FLOP/byte), far below the ~20 FLOP/byte where f32 CUDA-core math
// would become the limit, so the goal is to stream M once at full width.
// At the tracking shapes (<= 5 MB) the two launches and each block's serial
// multiply-add chain cost more than the stream itself, so blocks are short
// (256 rows) and each thread keeps ILP independent accumulators.
//
// Design: two passes and no float atomics, so the result is bit-identical
// from run to run (the property the TPU kernel pins by walking its grid in
// order).
//   pass 1  each block owns a fixed range of ROWS_PER_BLOCK rows.  It stages
//           CHUNK rows at a time in shared memory with coalesced loads; every
//           thread owns one (i, j) entry of one row group and accumulates it
//           over that group's rows, round-robin into ILP registers.  The
//           registers and then the row groups are summed in a fixed order and
//           the block writes its C x C partial to scratch.
//   pass 2  one block sums the partials in block order.
// Rows past P load as zero, so zero padding never changes the result.

#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int ROWS_PER_BLOCK = 256;
constexpr int CHUNK = 256;  // rows staged in shared memory at a time
constexpr int ILP = 4;      // independent accumulators per thread

template <int C>
__global__ void __launch_bounds__(THREADS)
gram_partial_kernel(const float* __restrict__ M, float* __restrict__ partials, int P) {
  constexpr int CC = C * C;
  constexpr int GROUPS = THREADS / CC;  // rows are split over this many groups
  __shared__ float tile[CHUNK * C];
  __shared__ float red[THREADS];

  const int t = threadIdx.x;
  const int g = t / CC;
  const int e = t % CC;
  const int i = e / C;
  const int j = e % C;
  const long long limit = static_cast<long long>(P) * C;
  const long long block_base = static_cast<long long>(blockIdx.x) * ROWS_PER_BLOCK * C;

  static_assert(CHUNK % (GROUPS * ILP) == 0, "chunk must split evenly");
  float acc[ILP] = {};
  for (int c0 = 0; c0 < ROWS_PER_BLOCK; c0 += CHUNK) {
    const long long base = block_base + static_cast<long long>(c0) * C;
    for (int k = t; k < CHUNK * C; k += THREADS) {
      const long long idx = base + k;
      tile[k] = idx < limit ? M[idx] : 0.0f;
    }
    __syncthreads();
    for (int r = g; r < CHUNK; r += GROUPS * ILP) {
#pragma unroll
      for (int q = 0; q < ILP; ++q) {
        const int row = r + q * GROUPS;
        acc[q] = fmaf(tile[row * C + i], tile[row * C + j], acc[q]);
      }
    }
    __syncthreads();
  }
  float mine = acc[0];
#pragma unroll
  for (int q = 1; q < ILP; ++q) mine += acc[q];
  red[t] = mine;
  __syncthreads();
  if (t < CC) {
    float s = red[t];
    for (int q = 1; q < GROUPS; ++q) s += red[q * CC + t];
    partials[static_cast<long long>(blockIdx.x) * CC + t] = s;
  }
}

template <int C>
__global__ void gram_final_kernel(const float* __restrict__ partials, float* __restrict__ out,
                                  int n_blocks) {
  constexpr int CC = C * C;
  const int t = threadIdx.x;
  if (t >= CC) return;
  float s = 0.0f;
  for (int b = 0; b < n_blocks; ++b) s += partials[static_cast<long long>(b) * CC + t];
  out[t] = s;
}

template <int C>
int launch(const float* M, float* partials, float* out, int P, cudaStream_t stream) {
  const int n_blocks = (P + ROWS_PER_BLOCK - 1) / ROWS_PER_BLOCK;
  if (n_blocks > 0) {
    gram_partial_kernel<C><<<n_blocks, THREADS, 0, stream>>>(M, partials, P);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  gram_final_kernel<C><<<1, C * C, 0, stream>>>(partials, out, n_blocks);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Rows each pass-1 block reduces; the wrapper sizes the partials with it.
int gram_rows_per_block() { return ROWS_PER_BLOCK; }

// M: f32 [P, C] contiguous; partials: f32 [ceil(P / rows_per_block), C, C];
// out: f32 [C, C].  Launches on `stream` without synchronising and returns
// cudaGetLastError() (0 = launched).
int gram_f32(const float* M, float* partials, float* out, int P, int C, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (P < 0) return static_cast<int>(cudaErrorInvalidValue);
  switch (C) {
    case 8:
      return launch<8>(M, partials, out, P, s);
    case 16:
      return launch<16>(M, partials, out, P, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // extern "C"
