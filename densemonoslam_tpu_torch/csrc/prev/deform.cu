// Previous design of this kernel, kept only as the yardstick that
// chip_smoke.py times beside the current one in the same run ("prev_ms").
// The port never calls it.
//
// Embedded-deformation apply over the whole surfel map (kernel K2).
//
// Replaces the TPU kernel `densemonoslam_tpu/ops/pallas/deform.py`
// (`deform_soa_pallas`, body `_deform_kernel`), which
// `deformation.apply_to_map` runs on every accepted loop closure.  For every
// map row r < count with conf > 0, with position p, normal n and creation
// time tau (column 11):
//   1. ins   = #{nodes with time <= tau}  (node times are sorted ascending,
//              invalid nodes last at +inf, so this is a binary search);
//   2. start = clip(ins - 20, 0, max(n_valid - 20, 0));
//   3. the candidates are nodes j in [start, start + 20) with j < n_valid
//      and valid[j];
//   4. the 5 nearest by squared distance (the lower node index wins a tie);
//   5. the 4 nearest weighted w = (1 - d/d5)^2, d5 clamped at >= 1e-6,
//      w = 0 where d is not finite, then normalised;
//   6. where sum(w) > 1e-9: p' = (sum w A_k) p + sum w c_k with
//      c_k = g_k + t_k - A_k g_k, and n' = normalise((sum w A_k) n), the norm
//      clamped at 1e-9.  Otherwise the row is left as it is.
// Columns 0:3 and 8:11 of a deformed row are rewritten in place; every other
// byte of the map stays as it was.
//
// What bounds it on Hopper: device memory.  A row needs 32 bytes read
// (columns 0-3 and 8-11) and 24 written, ~330 f32 operations, so at the
// 1<<20-row map it moves ~59 MB (~18 us at 3.35 TB/s) against ~0.35 GFLOP
// (~5 us at 67 TFLOP/s).
//
// Design: the TPU kernel measures every point against all K nodes through a
// [B, 128, K] mask and an MXU product; on Hopper each thread owns one row.
// Each block stages the node table (K <= 512: positions, times, valid flags,
// A and its own c_k, ~33 KB) in shared memory and counts the valid nodes;
// each thread then binary-searches the times, scans only its 20-node window,
// keeps the 5 smallest distances in registers by insertion, and blends 4
// nodes.  A row is read as two float4 loads and written back as two float4
// stores.  `count` is read on the device, so the launch needs no host read.
// No atomics: reruns are bit-identical.  Blocks walk the rows grid-stride,
// 6 blocks per SM (33 KB of shared memory and 1536 threads per SM), so the
// node table is staged ~800 times, not once per 256 rows.

#include <cuda_runtime.h>

namespace {

constexpr int MAX_NODES = 512;
constexpr int LOOKBACK = 20;
constexpr int NEAREST = 5;  // k = 4 blend nodes + 1 for the normaliser d5
constexpr int THREADS = 256;
constexpr int COLS = 16;
constexpr int BLOCKS_PER_SM = 6;

__global__ void __launch_bounds__(THREADS, BLOCKS_PER_SM)
deform_map_kernel(float* __restrict__ data, long long n_rows,
                  const long long* __restrict__ count_ptr,
                  const float* __restrict__ pos, const float* __restrict__ time,
                  const unsigned char* __restrict__ valid, const float* __restrict__ A,
                  const float* __restrict__ t, int K) {
  __shared__ float s_time[MAX_NODES];
  __shared__ float s_pos[MAX_NODES * 3];
  __shared__ float s_A[MAX_NODES * 9];
  __shared__ float s_c[MAX_NODES * 3];
  __shared__ unsigned char s_valid[MAX_NODES];

  int n_valid = 0;
  for (int k0 = 0; k0 < K; k0 += THREADS) {
    const int k = k0 + threadIdx.x;
    bool ok = false;
    if (k < K) {
      float g[3], a[9];
#pragma unroll
      for (int i = 0; i < 3; ++i) g[i] = pos[3 * k + i];
#pragma unroll
      for (int m = 0; m < 9; ++m) a[m] = A[9 * k + m];
#pragma unroll
      for (int i = 0; i < 3; ++i) {
        s_pos[3 * k + i] = g[i];
        s_c[3 * k + i] =
            (g[i] + t[3 * k + i]) - (a[3 * i] * g[0] + a[3 * i + 1] * g[1] + a[3 * i + 2] * g[2]);
      }
#pragma unroll
      for (int m = 0; m < 9; ++m) s_A[9 * k + m] = a[m];
      s_time[k] = time[k];
      ok = valid[k] != 0;
      s_valid[k] = ok;
    }
    n_valid += __syncthreads_count(ok);  // also the barrier before the table is read
  }

  const long long count = *count_ptr;
  const long long limit = count < n_rows ? count : n_rows;
  const long long stride = static_cast<long long>(gridDim.x) * THREADS;
  for (long long r = static_cast<long long>(blockIdx.x) * THREADS + threadIdx.x; r < limit;
       r += stride) {
    float4* row = reinterpret_cast<float4*>(data + r * COLS);
    const float4 p = row[0];  // x, y, z, conf
    if (!(p.w > 0.0f)) continue;
    const float4 n = row[2];  // nx, ny, nz, init_time

    int lo = 0, hi = K;
    while (lo < hi) {
      const int mid = (lo + hi) >> 1;
      if (s_time[mid] <= n.w) lo = mid + 1;
      else hi = mid;
    }
    const int top = n_valid - LOOKBACK > 0 ? n_valid - LOOKBACK : 0;
    int start = lo - LOOKBACK > 0 ? lo - LOOKBACK : 0;
    start = start < top ? start : top;

    float bd[NEAREST];
    int bi[NEAREST];
#pragma unroll
    for (int s = 0; s < NEAREST; ++s) {
      bd[s] = __int_as_float(0x7f800000);  // +inf
      bi[s] = 0;
    }
    for (int q = 0; q < LOOKBACK; ++q) {
      const int j = start + q;
      if (j >= n_valid || j >= K || !s_valid[j]) continue;
      const float dx = p.x - s_pos[3 * j];
      const float dy = p.y - s_pos[3 * j + 1];
      const float dz = p.z - s_pos[3 * j + 2];
      const float d2 = dx * dx + dy * dy + dz * dz;
      // bubble the candidate in from the front: at each slot the smaller
      // of the two stays and the other moves on.  Strict `<` keeps an equal
      // distance found earlier (lower node index) in front, and the static
      // slot indices keep the list in registers.
      float cd = d2;
      int cj = j;
#pragma unroll
      for (int s = 0; s < NEAREST; ++s) {
        if (cd < bd[s]) {
          const float td = bd[s];
          const int tj = bi[s];
          bd[s] = cd;
          bi[s] = cj;
          cd = td;
          cj = tj;
        }
      }
    }

    const float dmax = fmaxf(sqrtf(fmaxf(bd[NEAREST - 1], 0.0f)), 1e-6f);
    float w[NEAREST - 1];
    float wsum = 0.0f;
#pragma unroll
    for (int s = 0; s < NEAREST - 1; ++s) {
      const float d = sqrtf(fmaxf(bd[s], 0.0f));
      const float u = 1.0f - d / dmax;
      w[s] = d <= 3.402823466e+38f ? u * u : 0.0f;  // 0 where d is inf (or NaN)
      wsum += w[s];
    }
    if (!(wsum > 1e-9f)) continue;  // no support: the row passes through
    const float wden = fmaxf(wsum, 1e-9f);

    float b[12];
#pragma unroll
    for (int m = 0; m < 12; ++m) b[m] = 0.0f;
#pragma unroll
    for (int s = 0; s < NEAREST - 1; ++s) {
      if (!(w[s] > 0.0f)) continue;
      const float ws = w[s] / wden;
      const int k = bi[s];
#pragma unroll
      for (int m = 0; m < 9; ++m) b[m] += ws * s_A[9 * k + m];
#pragma unroll
      for (int m = 0; m < 3; ++m) b[9 + m] += ws * s_c[3 * k + m];
    }
    const float ox = b[0] * p.x + b[1] * p.y + b[2] * p.z + b[9];
    const float oy = b[3] * p.x + b[4] * p.y + b[5] * p.z + b[10];
    const float oz = b[6] * p.x + b[7] * p.y + b[8] * p.z + b[11];
    const float rx = b[0] * n.x + b[1] * n.y + b[2] * n.z;
    const float ry = b[3] * n.x + b[4] * n.y + b[5] * n.z;
    const float rz = b[6] * n.x + b[7] * n.y + b[8] * n.z;
    const float norm = fmaxf(sqrtf(rx * rx + ry * ry + rz * rz), 1e-9f);
    row[0] = make_float4(ox, oy, oz, p.w);
    row[2] = make_float4(rx / norm, ry / norm, rz / norm, n.w);
  }
}

}  // namespace

extern "C" {

// Largest node table the kernel stages in shared memory.
int deform_max_nodes() { return MAX_NODES; }

// data: f32 [n_rows + 1, 16] contiguous, 16-byte aligned, updated in place;
// count: int64 [] on the device (rows >= count are never touched);
// pos f32 [K, 3], time f32 [K] (ascending, invalid nodes last), valid u8 [K],
// A f32 [K, 3, 3], t f32 [K, 3], 1 <= K <= 512.  Launches on `stream`
// without synchronising and returns cudaGetLastError() (0 = launched).
int deform_map_f32(float* data, long long n_rows, const long long* count, const float* pos,
                   const float* time, const unsigned char* valid, const float* A, const float* t,
                   int K, void* stream) {
  if (K < 1 || K > MAX_NODES || n_rows < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (n_rows == 0) return 0;
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  long long blocks = (n_rows + THREADS - 1) / THREADS;
  const long long cap = static_cast<long long>(sms) * BLOCKS_PER_SM;
  if (blocks > cap) blocks = cap;
  deform_map_kernel<<<static_cast<unsigned int>(blocks), THREADS, 0,
                      static_cast<cudaStream_t>(stream)>>>(data, n_rows, count, pos, time, valid,
                                                           A, t, K);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
