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
//   4. the 5 nearest by squared distance (of equally near nodes, the lower
//      index comes first: `lax.top_k`'s order);
//   5. the 4 nearest weighted w = (1 - d/d5)^2, d5 clamped at >= 1e-6,
//      w = 0 where d is not finite, then normalised;
//   6. where sum(w) > 1e-9: p' = (sum w A_k) p + sum w c_k with
//      c_k = g_k + t_k - A_k g_k, and n' = normalise((sum w A_k) n), the norm
//      clamped at 1e-9.  Otherwise the row is left as it is.
// Columns 0:3 and 8:11 of a deformed row are rewritten in place; every other
// byte of the map stays as it was.
//
// What bounds it on Hopper: instruction issue, then device memory.  A row
// reads both 32-byte sectors of its 64 bytes (columns 0-3 and 8-11) and
// writes 24 bytes; at the 1<<20-row map that floor is ~86 MB, ~26 us at
// 3.35 TB/s.  Selecting the 5 nearest of 20 candidates costs more than the
// bytes: a 5-slot insertion is ~25 instructions, and a row that tries every
// candidate spends ~1000 instructions on its binary search, selection and
// blend, which on 132 SMs takes longer than the stream.
//
// Design: two launches.  A one-block prologue writes the node table once per
// call: per node 64 bytes, [A row-major 9 | c 3 | x y z flag], the flag
// being valid[j] && j < n_valid, and n_valid after the table.  The main
// kernel stages times and {x, y, z, flag} (10 KB) in each block's shared
// memory and gives each block one contiguous range of rows, walked a warp
// of 32 consecutive rows at a time.  Rows are stored in time order within
// each partition of the map, so a warp's rows nearly always share one
// window.  Each lane binary-searches its row's window start; when the live
// lanes agree (`__reduce_min_sync` == `__reduce_max_sync`), the warp takes
// the uniform path: one ballot marks the window's valid nodes and every
// lane visits them together, reading the same node (a broadcast) with no
// divergent branch.  Otherwise each lane scans its own window (the
// per-thread path).  Both visit in increasing node index, the 5 kept are
// the first 5 of the total order (distance, then node index), and the
// arithmetic is explicitly rounded, so a row gets the same bits on either
// path.  The blend reads A and c of its 4 nodes as 3 float4 loads each from
// the (cache-resident) table.  `count` is read on the device, so the launch
// needs no host read.  No atomics: reruns are bit-identical.

#include <climits>
#include <cuda_runtime.h>

namespace {

constexpr int MAX_NODES = 512;
constexpr int LOOKBACK = 20;
constexpr int NEAREST = 5;  // k = 4 blend nodes + 1 for the normaliser d5
constexpr int THREADS = 256;
constexpr int COLS = 16;
constexpr int BLOCKS_PER_SM = 4;
constexpr unsigned FULL = 0xffffffffu;

// One block of MAX_NODES threads: the node table `tab` ([K][4] float4) and
// n_valid (the int after it).
__global__ void __launch_bounds__(MAX_NODES)
deform_nodes_kernel(const float* __restrict__ pos, const unsigned char* __restrict__ valid,
                    const float* __restrict__ A, const float* __restrict__ t, int K,
                    float4* __restrict__ tab) {
  const int k = threadIdx.x;
  const bool ok = k < K && valid[k] != 0;
  const int n_valid = __syncthreads_count(ok);
  if (k < K) {
    float g[3], a[9], c[3];
#pragma unroll
    for (int i = 0; i < 3; ++i) g[i] = pos[3 * k + i];
#pragma unroll
    for (int m = 0; m < 9; ++m) a[m] = A[9 * k + m];
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      c[i] = (g[i] + t[3 * k + i]) - (a[3 * i] * g[0] + a[3 * i + 1] * g[1] + a[3 * i + 2] * g[2]);
    }
    tab[4 * k + 0] = make_float4(a[0], a[1], a[2], a[3]);
    tab[4 * k + 1] = make_float4(a[4], a[5], a[6], a[7]);
    tab[4 * k + 2] = make_float4(a[8], c[0], c[1], c[2]);
    tab[4 * k + 3] = make_float4(g[0], g[1], g[2], ok && k < n_valid ? 1.0f : 0.0f);
  }
  if (k == 0) *reinterpret_cast<int*>(tab + 4 * K) = n_valid;
}

// (d, j) comes before (e, k) in the selection's order: the nearer first, and
// of two equally near nodes the lower index.
__device__ __forceinline__ bool before(float d, int j, float e, int k) {
  return d < e || (d == e && j < k);
}

__device__ __forceinline__ float dist2(const float4& p, const float4& g) {
  const float dx = __fsub_rn(p.x, g.x);
  const float dy = __fsub_rn(p.y, g.y);
  const float dz = __fsub_rn(p.z, g.z);
  return __fmaf_rn(dz, dz, __fmaf_rn(dy, dy, __fmul_rn(dx, dx)));
}

// Node j at g (a valid node) as a candidate of the row at p: keep the first
// 5 in the selection's order in (bd, bi), sorted.  The order is total, so
// the 5 kept do not depend on the order in which candidates come.
__device__ __forceinline__ void consider(const float4& p, const float4& g, int j,
                                         float (&bd)[NEAREST], int (&bi)[NEAREST]) {
  const float d2 = dist2(p, g);
  if (!before(d2, j, bd[NEAREST - 1], bi[NEAREST - 1])) return;  // it stays out
  // bubble the candidate in from the front: at each slot the earlier of the
  // two stays and the other moves on; static slots stay in registers
  float cd = d2;
  int cj = j;
#pragma unroll
  for (int s = 0; s < NEAREST; ++s) {
    if (before(cd, cj, bd[s], bi[s])) {
      const float td = bd[s];
      const int tj = bi[s];
      bd[s] = cd;
      bi[s] = cj;
      cd = td;
      cj = tj;
    }
  }
}

__global__ void __launch_bounds__(THREADS, BLOCKS_PER_SM)
deform_map_kernel(float* __restrict__ data, long long n_rows,
                  const long long* __restrict__ count_ptr, const float* __restrict__ time,
                  const float4* __restrict__ tab, int K) {
  __shared__ float s_time[MAX_NODES];
  __shared__ float4 s_node[MAX_NODES];  // x, y, z, flag
  for (int k = threadIdx.x; k < K; k += THREADS) {
    s_time[k] = time[k];
    s_node[k] = tab[4 * k + 3];
  }
  __syncthreads();
  const int n_valid = *reinterpret_cast<const int*>(tab + 4 * K);
  const int top = n_valid - LOOKBACK > 0 ? n_valid - LOOKBACK : 0;

  const long long count = *count_ptr;
  const long long limit = count < 0 ? 0 : (count < n_rows ? count : n_rows);
  // one contiguous range per block, a whole number of THREADS rows
  const long long per_block =
      ((limit + gridDim.x - 1) / gridDim.x + THREADS - 1) / THREADS * THREADS;
  const long long begin = static_cast<long long>(blockIdx.x) * per_block;
  const long long end = begin + per_block < limit ? begin + per_block : limit;
  const int lane = threadIdx.x & 31;

  for (long long base = begin + (threadIdx.x & ~31); base < end; base += THREADS) {
    const long long r = base + lane;
    float4* row = reinterpret_cast<float4*>(data + r * COLS);
    float4 p = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    float4 n = p;
    bool live = false;
    if (r < end) {
      p = row[0];  // x, y, z, conf
      live = p.w > 0.0f;
      if (live) n = row[2];  // nx, ny, nz, init_time
    }
    const unsigned live_lanes = __ballot_sync(FULL, live);
    if (live_lanes == 0) continue;  // warp-uniform

    int start = 0;
    if (live) {
      int lo = 0, hi = K;
      while (lo < hi) {
        const int mid = (lo + hi) >> 1;
        if (s_time[mid] <= n.w) lo = mid + 1;
        else hi = mid;
      }
      start = lo - LOOKBACK > 0 ? lo - LOOKBACK : 0;
      start = start < top ? start : top;
    }
    const int first = __reduce_min_sync(FULL, live ? start : INT_MAX);
    const int last = __reduce_max_sync(FULL, live ? start : INT_MIN);

    float bd[NEAREST];
    int bi[NEAREST];
#pragma unroll
    for (int s = 0; s < NEAREST; ++s) {
      bd[s] = __int_as_float(0x7f800000);  // +inf
      bi[s] = 0;
    }
    if (first == last) {
      // uniform path: one window for the warp.  Lane q tests node first + q
      // once; the ballot of valid nodes drives the visits, so every lane
      // reads the same node (a broadcast) and no branch diverges.
      const int j = first + lane;
      const unsigned ok =
          __ballot_sync(FULL, lane < LOOKBACK && j < K && s_node[j].w != 0.0f);
#pragma unroll
      for (int q = 0; q < LOOKBACK; ++q) {
        if (ok >> q & 1u) consider(p, s_node[first + q], first + q, bd, bi);
      }
    } else {
      // per-thread path: each lane its own window
#pragma unroll
      for (int q = 0; q < LOOKBACK; ++q) {
        const int j = start + q;
        if (j < K) {
          const float4 g = s_node[j];
          if (g.w != 0.0f) consider(p, g, j, bd, bi);
        }
      }
    }
    if (!live) continue;

    const float dmax = fmaxf(sqrtf(fmaxf(bd[NEAREST - 1], 0.0f)), 1e-6f);
    const float inv_dmax = 1.0f / dmax;
    float w[NEAREST - 1];
    float wsum = 0.0f;
#pragma unroll
    for (int s = 0; s < NEAREST - 1; ++s) {
      const float d = sqrtf(fmaxf(bd[s], 0.0f));
      const float u = 1.0f - d * inv_dmax;
      w[s] = d <= 3.402823466e+38f ? u * u : 0.0f;  // 0 where d is inf (or NaN)
      wsum += w[s];
    }
    if (!(wsum > 1e-9f)) continue;  // no support: the row passes through
    const float inv_den = 1.0f / fmaxf(wsum, 1e-9f);

    float b[12];
#pragma unroll
    for (int m = 0; m < 12; ++m) b[m] = 0.0f;
#pragma unroll
    for (int s = 0; s < NEAREST - 1; ++s) {
      if (!(w[s] > 0.0f)) continue;
      const float ws = w[s] * inv_den;
      const float4* node = tab + 4 * bi[s];
      const float4 x = __ldg(node), y = __ldg(node + 1), z = __ldg(node + 2);
      const float v[12] = {x.x, x.y, x.z, x.w, y.x, y.y, y.z, y.w, z.x, z.y, z.z, z.w};
#pragma unroll
      for (int m = 0; m < 12; ++m) b[m] += ws * v[m];
    }
    const float ox = b[0] * p.x + b[1] * p.y + b[2] * p.z + b[9];
    const float oy = b[3] * p.x + b[4] * p.y + b[5] * p.z + b[10];
    const float oz = b[6] * p.x + b[7] * p.y + b[8] * p.z + b[11];
    const float rx = b[0] * n.x + b[1] * n.y + b[2] * n.z;
    const float ry = b[3] * n.x + b[4] * n.y + b[5] * n.z;
    const float rz = b[6] * n.x + b[7] * n.y + b[8] * n.z;
    const float norm = fmaxf(sqrtf(rx * rx + ry * ry + rz * rz), 1e-9f);
    row[0] = make_float4(ox, oy, oz, p.w);
    const float inv_norm = 1.0f / norm;
    row[2] = make_float4(rx * inv_norm, ry * inv_norm, rz * inv_norm, n.w);
  }
}

}  // namespace

extern "C" {

// Largest node table the kernel stages in shared memory.
int deform_max_nodes() { return MAX_NODES; }

// data: f32 [n_rows + 1, 16] contiguous, 16-byte aligned, updated in place;
// count: int64 [] on the device (rows >= count are never touched);
// pos f32 [K, 3], time f32 [K] (ascending, invalid nodes last), valid u8 [K],
// A f32 [K, 3, 3], t f32 [K, 3], 1 <= K <= 512; table: 16-byte aligned
// scratch of 16 K + 4 floats.  Launches the prologue and the main kernel on
// `stream` of CUDA device `device` without synchronising and returns
// cudaGetLastError() (0 = launched).
int deform_map_f32(float* data, long long n_rows, const long long* count, const float* pos,
                   const float* time, const unsigned char* valid, const float* A, const float* t,
                   int K, float* table, int device, void* stream) {
  if (K < 1 || K > MAX_NODES || n_rows < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (n_rows == 0) return 0;
  int current = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&current);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (current != device && (err = cudaSetDevice(device)) != cudaSuccess) return static_cast<int>(err);
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err == cudaSuccess) {
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    float4* tab = reinterpret_cast<float4*>(table);
    deform_nodes_kernel<<<1, MAX_NODES, 0, s>>>(pos, valid, A, t, K, tab);
    err = cudaGetLastError();
    if (err == cudaSuccess) {
      long long blocks = (n_rows + THREADS - 1) / THREADS;
      const long long cap = static_cast<long long>(sms) * BLOCKS_PER_SM;
      if (blocks > cap) blocks = cap;
      deform_map_kernel<<<static_cast<unsigned int>(blocks), THREADS, 0, s>>>(data, n_rows, count,
                                                                             time, tab, K);
      err = cudaGetLastError();
    }
  }
  if (current != device) cudaSetDevice(current);
  return static_cast<int>(err);
}

}  // extern "C"
