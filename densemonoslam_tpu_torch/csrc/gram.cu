// Gram reduction G = M^T M for the tall-skinny row matrices of dense tracking
// (kernel K1).
//
// Replaces the TPU kernel `densemonoslam_tpu/ops/pallas/gram.py`
// (`gram_pallas`, body `_gram_kernel`), which `reductions.gram` calls in
// every SO3 and Gauss-Newton iteration: M is f32 [P, C] with C = 8 (SO3
// pre-align rows) or C = 16 (joint ICP+RGB rows), P up to ~77k per call.
//
// What bounds it on Hopper: fixed cost per call, then device memory.  One
// row is C*4 bytes and feeds C*(C+1)/2 multiply-adds (~2 FLOP/byte), so the
// stream of M is the only real work; at the tracking shapes (0.15-5 MB) it
// takes 0.05-1.5 us at 3.35 TB/s, less than a launch.  The fixed costs are
// the launch, the first copy's latency and the cross-block step after the
// last byte (a ticket, then one block reading every partial triangle).  So
// the design spends one launch per call, keeps bytes in flight from the
// first cycle, and keeps the cross-block step to one release/acquire ticket
// and one round of loads that are all in flight together.
//
// Design: one launch, no float atomics, bit-identical from run to run and
// under appended zero rows.
//   chunks   M is cut into CHUNK_BYTES pieces.  Chunk c goes to block
//            c mod MAX_BLOCKS and each block walks its chunks in increasing
//            order, so the order of summation depends on P alone; extra
//            zero rows only append exact zeros to some block's sequence or
//            add all-zero partials after the others.
//   copies   thread 0 brings each chunk into shared memory with one bulk
//            copy (`cp.async.bulk` completing on an mbarrier), STAGES chunks
//            in flight per block.  The ragged last chunk copies only the
//            bytes that exist (rows are 32 or 64 bytes, so a multiple of
//            16) and its threads stop at the last row.
//   math     only the upper triangle is accumulated: the C columns form 4
//            column blocks of width W = C/4, and the 10 blocks (i <= j) of
//            the block triangle are the 10 tiles.  Each thread owns one
//            W x W tile of one of 32 row groups (320 threads), so it loads
//            2W values of a row for W*W multiply-adds.
//   reduce   the block sums its row groups in order and writes its
//            triangle to scratch; after a barrier, one thread draws an
//            integer ticket with a release/acquire atomic (no float
//            atomics, no fence by every thread).  The block that draws the
//            last one sums every block's triangle in block order
//            (interleaved float4 partial sums, combined in a fixed order),
//            mirrors it into `out` and resets the ticket.
// The scratch and the ticket belong to one stream (the wrapper keeps one
// pair per device and stream), so two streams never share a ticket.

#include <cuda_runtime.h>

namespace {

constexpr int TILES = 10;                  // upper triangle of a 4 x 4 block grid
constexpr int GROUPS = 32;                 // row groups per block
constexpr int THREADS = TILES * GROUPS;    // 320
constexpr int CHUNK_BYTES = 8192;          // 128 rows at C = 16, 256 at C = 8
constexpr int STAGES = 5;                  // chunks in flight per block (40 KB)
constexpr int MAX_BLOCKS = 128;            // chunk c -> block c mod MAX_BLOCKS

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// Wait for the phase of `bar` with this parity to complete; a copy that
// never lands traps (a launch error) instead of hanging the card.
__device__ __forceinline__ void bar_wait(unsigned bar, unsigned parity) {
  unsigned done = 0;
  for (unsigned polls = 0; !done; ++polls) {
    if (polls == (1u << 26)) __trap();
    asm volatile(
        "{\n\t.reg .pred p;\n\t"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
        "selp.u32 %0, 1, 0, p;\n\t}"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  }
}

// (row, column) of entry e of the row-major upper triangle of a C x C matrix
template <int C>
__device__ __forceinline__ void tri_entry(int e, int& i, int& j) {
  i = 0;
  while (e >= C - i) {
    e -= C - i;
    ++i;
  }
  j = i + e;
}

template <int C>
__global__ void __launch_bounds__(THREADS)
gram_kernel(const float* __restrict__ M, long long P, float* __restrict__ partials,
            unsigned* __restrict__ ticket, float* __restrict__ out) {
  constexpr int W = C / 4;
  constexpr int E = C * (C + 1) / 2;
  constexpr int CHUNK_ROWS = CHUNK_BYTES / (C * 4);
  static_assert(GROUPS * TILES * W * W <= STAGES * CHUNK_BYTES / 4, "row-group sums fit the stages");
  __shared__ alignas(128) float buf[STAGES][CHUNK_BYTES / 4];
  __shared__ alignas(8) unsigned long long bar[STAGES];
  __shared__ bool s_last;

  const int t = threadIdx.x;
  const int tile = t % TILES;
  const int g = t / TILES;
  int bi = 0, rem = tile;
  while (rem >= 4 - bi) {
    rem -= 4 - bi;
    ++bi;
  }
  const int bj = bi + rem;

  const long long total = P * C * 4;  // bytes of M
  const long long n_chunks = (total + CHUNK_BYTES - 1) / CHUNK_BYTES;
  const long long G = gridDim.x;
  const long long mine = n_chunks > blockIdx.x ? (n_chunks - 1 - blockIdx.x) / G + 1 : 0;

  if (t == 0) {
#pragma unroll
    for (int s = 0; s < STAGES; ++s) {
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(smem_u32(&bar[s])) : "memory");
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  // thread 0: bring the block's k-th chunk into stage k mod STAGES
  auto issue = [&](long long k) {
    const long long off = (blockIdx.x + k * G) * CHUNK_BYTES;
    const long long left = total - off;
    const unsigned bytes = left < CHUNK_BYTES ? static_cast<unsigned>(left) : CHUNK_BYTES;
    const unsigned b = smem_u32(&bar[k % STAGES]);
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(b), "r"(bytes)
                 : "memory");
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];" ::
            "r"(smem_u32(buf[k % STAGES])),
        "l"(reinterpret_cast<const char*>(M) + off), "r"(bytes), "r"(b)
        : "memory");
  };
  if (t == 0) {
    for (long long k = 0; k < mine && k < STAGES; ++k) issue(k);
  }

  float acc[W][W];
#pragma unroll
  for (int i = 0; i < W; ++i)
#pragma unroll
    for (int j = 0; j < W; ++j) acc[i][j] = 0.0f;

  for (long long k = 0; k < mine; ++k) {
    const int s = static_cast<int>(k % STAGES);
    bar_wait(smem_u32(&bar[s]), static_cast<unsigned>((k / STAGES) & 1));
    const long long first = (blockIdx.x + k * G) * CHUNK_ROWS;
    const int rows = P - first < CHUNK_ROWS ? static_cast<int>(P - first) : CHUNK_ROWS;
    const float* chunk = buf[s];
    for (int r = g; r < rows; r += GROUPS) {
      float a[W], b[W];
      if constexpr (W == 4) {
        const float4 x = *reinterpret_cast<const float4*>(chunk + r * C + bi * W);
        const float4 y = *reinterpret_cast<const float4*>(chunk + r * C + bj * W);
        a[0] = x.x; a[1] = x.y; a[2] = x.z; a[3] = x.w;
        b[0] = y.x; b[1] = y.y; b[2] = y.z; b[3] = y.w;
      } else {
        const float2 x = *reinterpret_cast<const float2*>(chunk + r * C + bi * W);
        const float2 y = *reinterpret_cast<const float2*>(chunk + r * C + bj * W);
        a[0] = x.x; a[1] = x.y;
        b[0] = y.x; b[1] = y.y;
      }
#pragma unroll
      for (int i = 0; i < W; ++i)
#pragma unroll
        for (int j = 0; j < W; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();  // every thread is done with stage s
    if (t == 0 && k + STAGES < mine) issue(k + STAGES);
  }

  // the stages are free now: sum the row groups of each upper entry in order
  float* red = &buf[0][0];
#pragma unroll
  for (int i = 0; i < W; ++i)
#pragma unroll
    for (int j = 0; j < W; ++j) red[(g * TILES + tile) * W * W + i * W + j] = acc[i][j];
  __syncthreads();
  for (int e = t; e < E; e += THREADS) {
    int i, j;
    tri_entry<C>(e, i, j);
    const int ti = i / W, tj = j / W;
    const int te = ti * 4 - ti * (ti - 1) / 2 + (tj - ti);
    const int slot = (i % W) * W + (j % W);
    float s = red[te * W * W + slot];
    for (int q = 1; q < GROUPS; ++q) s += red[(q * TILES + te) * W * W + slot];
    partials[static_cast<long long>(blockIdx.x) * E + e] = s;
  }
  // The barrier orders the block's partial writes before thread 0's ticket;
  // the ticket's release makes them visible to the block that draws the last
  // one, whose acquire (then the barrier) orders its reads after them all.
  __syncthreads();
  if (t == 0) {
    unsigned drawn;
    asm volatile("atom.add.acq_rel.gpu.global.u32 %0, [%1], 1;"
                 : "=r"(drawn) : "l"(ticket) : "memory");
    s_last = drawn == gridDim.x - 1;
  }
  __syncthreads();
  if (!s_last) return;

  // the last block: every block's triangle, in block order.  Thread (s, q)
  // sums float4 column q of the triangles of blocks s, s + SPLIT, ...; all
  // its loads are issued before the first add (an index past the grid reads
  // the last block's triangle and is not added), so they are in flight
  // together.  The SPLIT sums of an entry are then added in split order.
  constexpr int Q = E / 4;
  constexpr int SPLIT = THREADS / Q;  // 9 at C = 16, 35 at C = 8
  constexpr int PER_SPLIT = (MAX_BLOCKS + SPLIT - 1) / SPLIT;
  static_assert(E % 4 == 0 && SPLIT * E <= STAGES * CHUNK_BYTES / 4, "split sums fit the stages");
  float4* part = reinterpret_cast<float4*>(&buf[0][0]);  // [SPLIT][Q]
  if (t < SPLIT * Q) {
    const int q = t % Q;
    const int last = static_cast<int>(gridDim.x) - 1;
    const float4* src = reinterpret_cast<const float4*>(partials) + q;
    float4 v[PER_SPLIT];
#pragma unroll
    for (int k = 0; k < PER_SPLIT; ++k) {
      const int b = t / Q + k * SPLIT;
      v[k] = __ldcg(src + (b < last ? b : last) * Q);
    }
    float4 sum = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
#pragma unroll
    for (int k = 0; k < PER_SPLIT; ++k) {
      if (t / Q + k * SPLIT <= last) {
        sum.x += v[k].x;
        sum.y += v[k].y;
        sum.z += v[k].z;
        sum.w += v[k].w;
      }
    }
    part[t] = sum;
  }
  __syncthreads();
  const float* split = &buf[0][0];
  for (int e = t; e < E; e += THREADS) {
    float s = split[e];
#pragma unroll
    for (int q = 1; q < SPLIT; ++q) s += split[q * E + e];
    int i, j;
    tri_entry<C>(e, i, j);
    out[i * C + j] = s;
    out[j * C + i] = s;
  }
  if (t == 0) *ticket = 0;
}

template <int C>
cudaError_t launch(const float* M, long long P, float* partials, unsigned* ticket, float* out,
                   cudaStream_t stream) {
  const long long chunks = (P * C * 4 + CHUNK_BYTES - 1) / CHUNK_BYTES;
  const int grid = chunks < 1 ? 1 : (chunks > MAX_BLOCKS ? MAX_BLOCKS : static_cast<int>(chunks));
  gram_kernel<C><<<grid, THREADS, 0, stream>>>(M, P, partials, ticket, out);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Floats of scratch one stream needs: a C = 16 triangle for every block.
int gram_scratch_floats() { return MAX_BLOCKS * 16 * 17 / 2; }

// M: f32 [P, C] contiguous, 16-byte aligned; partials: f32
// [gram_scratch_floats()]; ticket: one u32, 0 between calls, owned by
// `stream`; out: f32 [C, C].  Launches one kernel on `stream` of CUDA device
// `device` without synchronising and returns its cudaError_t (0 = launched).
int gram_f32(const float* M, long long P, int C, float* partials, unsigned* ticket, float* out,
             int device, void* stream) {
  if (P < 0 || (C != 8 && C != 16)) return static_cast<int>(cudaErrorInvalidValue);
  int current = 0;
  cudaError_t err = cudaGetDevice(&current);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (current != device && (err = cudaSetDevice(device)) != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  err = C == 8 ? launch<8>(M, P, partials, ticket, out, s) : launch<16>(M, P, partials, ticket, out, s);
  if (current != device) cudaSetDevice(current);
  return static_cast<int>(err);
}

}  // extern "C"
