// The render of the whole surfel map from one pose, in two launches
// (kernel K3): the loop check's INACTIVE model, the inter-map
// verification's render of the other map, and any other render of more
// than 1<<21 rows with no active window.
//
// Replaces no TPU kernel: the JAX package renders with XLA scatters
// (`densemonoslam_tpu/ops/splat.py` `render`), and the port's op-by-op
// version of that render (`ops/splat.py` `render_ops`, the exact
// two-scatter path at this size) stays as K3's plain version.  Op by op on
// the card it took every row of the capacity (1<<25), ~20 row-length
// temporaries, a scatter that sends every row that is not visible to one
// dump slot, a gather of the z-buffer over every row, a second scatter and
// a [N, 16] f32 table of 2.1 GB to gather H*W winners from: ~60-75 ms.
//
// What bounds it on Hopper: the rows' bytes.  A row is 64 bytes, two
// 32-byte sectors: position and confidence in the first, last-seen times in
// the second; ~1 GB for 15 M live rows, ~0.3 ms at 3.35 TB/s.  The pixels
// pass reads and writes ~30 MB at 640x480.
//
// Design: a memset of the key buffer, then two launches, nothing read back.
//   rows    a grid-stride loop over the rows below `count`, which is read
//           with the time and the inverse pose from device memory.  A row
//           loads its first 16 bytes (position, confidence) and its last 16
//           (last-seen times); a row that is not alive in the mode goes no
//           further.  It transforms and projects with the op-by-op path's
//           arithmetic: built without FMA contraction (`--fmad=false`), a
//           3-wide `torch.sum` in the card's order (`sum3`), `rintf` for
//           `torch.round` and the same float-to-int64 conversion.  Where
//           0.05 < z < depth_max and the centre pixel is in the image, it
//           takes one 64-bit atomicMin on key = bits(z) << 32 | row in an
//           H*W buffer (2.4 MB at 640x480, so it stays in L2).  z > 0, so
//           its bits order as its value: the key picks the least z, then the
//           least row, as the two scatters do.  There is no dump slot.  A
//           load of the key first skips the atomic where the row cannot win
//           (a stored key only falls, so a stale load only costs an atomic).
//   pixels  a thread a pixel, blocks of 32x8.  A block first builds the
//           candidate (u, v, z, pixel radius) of each cell of its tile and
//           halo in shared memory, from the cell's winning row.  Each pixel
//           then runs the disk resolve over its (2h+1)^2 cells in the
//           op-by-op order with the same strict `<`, recomputes its
//           winner's camera point and normal from the row, refines the
//           depth on the ray / tangent-plane intersection and writes every
//           field of the prediction, `cell` (the raw winner) included.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace zbuffer {

// surfel row columns (`mapping/surfel_map.py`)
constexpr int COLS = 16;
constexpr int CONF = 3, COLOR = 4, RADIUS = 7, NORMAL = 8, LAST_SEEN = 12;
constexpr int MODE_ACTIVE = 0, MODE_INACTIVE = 1, MODE_ALL = 2;

constexpr int ROW_THREADS = 256;
constexpr int ROW_BLOCKS_PER_SM = 8;
constexpr int TILE_X = 32, TILE_Y = 8;
constexpr int MAX_HALF = 3;  // splat_k up to 7
constexpr int MAX_CELLS = (TILE_X + 2 * MAX_HALF) * (TILE_Y + 2 * MAX_HALF);
constexpr unsigned long long EMPTY = ~0ull;
constexpr float FAR = 1e9f;  // `splat._FAR`

struct Params {
  const float* data;        // [N + 1, 16] surfel rows
  const long long* count;   // [] rows in use
  const float* tinv;        // [4, 4] world-to-camera, row-major
  const float* time;        // [] the render's tick
  unsigned long long* keys; // [H * W] scratch
  long long n_rows;         // N, the capacity
  int width, height;
  int mode;                 // MODE_*
  int half;                 // splat_k / 2
  float fx, fy, cx, cy;
  float inv_fx, inv_fy;     // 1 / fx, 1 / fy in f32: torch divides by a scalar so on the card
  float time_delta, depth_max, r_max;
  long long* index;         // [H, W]
  float* vmap;              // [H, W, 3]
  float* nmap;              // [H, W, 3]
  float* color;             // [H, W, 3]
  float* intensity;         // [H, W]
  float* depth;             // [H, W]
  float* time_out;          // [H, W]
  float* conf;              // [H, W]
  long long* cell;          // [H, W]
};

// `torch.sum(x, dim=-1)` of a contiguous last dimension of 3 on the card:
// two lanes an output, lane 0 adds elements 0 and 2, then lane 1's element 1
__device__ __forceinline__ float sum3(float a, float b, float c) { return (a + c) + b; }

// torch.amax / torch.clamp propagate a NaN; fmaxf / fminf drop it
__device__ __forceinline__ float max_nan(float a, float b) { return (a > b || isnan(a)) ? a : b; }
__device__ __forceinline__ float clamp_nan(float x, float lo, float hi) {
  return isnan(x) ? x : fminf(fmaxf(x, lo), hi);
}

struct Pose {
  float r[9], t[3];
};

__device__ __forceinline__ Pose load_pose(const float* T) {
  Pose p;
#pragma unroll
  for (int i = 0; i < 3; ++i) {
#pragma unroll
    for (int j = 0; j < 3; ++j) p.r[3 * i + j] = __ldg(T + 4 * i + j);
    p.t[i] = __ldg(T + 4 * i + 3);
  }
  return p;
}

// `se3.rotate_vectors` / `se3.transform_points`: the products, their sum,
// then the translation
__device__ __forceinline__ float3 rotate(const Pose& T, float x, float y, float z) {
  return make_float3(sum3(T.r[0] * x, T.r[1] * y, T.r[2] * z),
                     sum3(T.r[3] * x, T.r[4] * y, T.r[5] * z),
                     sum3(T.r[6] * x, T.r[7] * y, T.r[8] * z));
}

__device__ __forceinline__ float3 transform(const Pose& T, float x, float y, float z) {
  const float3 q = rotate(T, x, y, z);
  return make_float3(q.x + T.t[0], q.y + T.t[1], q.z + T.t[2]);
}

// the centre pixel coordinates (u, v) of a camera point
__device__ __forceinline__ float2 project(const Params& p, float3 pc) {
  const float zs = fmaxf(pc.z, 1e-6f);
  return make_float2(pc.x / zs * p.fx + p.cx, pc.y / zs * p.fy + p.cy);
}

__device__ __forceinline__ float pixel_radius(const Params& p, float radius, float z) {
  return clamp_nan(radius * p.fx / fmaxf(z, 1e-6f), 0.5f, p.r_max);
}

__device__ __forceinline__ float last_seen(const float* row) {
  return max_nan(max_nan(row[LAST_SEEN], row[LAST_SEEN + 1]), row[LAST_SEEN + 2]);
}

__global__ void __launch_bounds__(ROW_THREADS) rows_kernel(Params p) {
  const long long count = min(*p.count, p.n_rows);
  const float t_now = *p.time;
  const Pose T = load_pose(p.tinv);
  const float4* rows = reinterpret_cast<const float4*>(p.data);
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long r = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x; r < count;
       r += stride) {
    const float4 a = __ldcs(rows + 4 * r);      // position, confidence
    const float4 b = __ldcs(rows + 4 * r + 3);  // last-seen times, cluster
    if (!(a.w > 0.0f)) continue;
    if (p.mode != MODE_ALL) {
      const float age = t_now - max_nan(max_nan(b.x, b.y), b.z);
      if (!(p.mode == MODE_ACTIVE ? age < p.time_delta
                                  : p.mode == MODE_INACTIVE && age >= p.time_delta))
        continue;
    }
    const float3 pc = transform(T, a.x, a.y, a.z);
    if (!(pc.z > 0.05f && pc.z < p.depth_max)) continue;
    const float2 uv = project(p, pc);
    const long long ui = static_cast<long long>(rintf(uv.x));
    const long long vi = static_cast<long long>(rintf(uv.y));
    if (ui < 0 || ui >= p.width || vi < 0 || vi >= p.height) continue;
    unsigned long long* slot = p.keys + (vi * p.width + ui);
    const unsigned long long key =
        (static_cast<unsigned long long>(__float_as_uint(pc.z)) << 32) |
        static_cast<unsigned long long>(r);
    if (key < __ldcg(slot)) atomicMin(slot, key);
  }
}

__global__ void __launch_bounds__(TILE_X * TILE_Y) pixels_kernel(Params p) {
  __shared__ float4 cand[MAX_CELLS];  // u, v, z, pixel radius
  __shared__ int cand_row[MAX_CELLS];  // the cell's winning row, -1 for none
  const int h = p.half, W = p.width, H = p.height;
  const int tw = TILE_X + 2 * h, th = TILE_Y + 2 * h;
  const int x0 = blockIdx.x * TILE_X - h, y0 = blockIdx.y * TILE_Y - h;
  const Pose T = load_pose(p.tinv);
  for (int i = threadIdx.y * TILE_X + threadIdx.x; i < tw * th; i += TILE_X * TILE_Y) {
    const int cx = x0 + i % tw, cy = y0 + i / tw;
    int row = -1;
    float4 c = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    if (cx >= 0 && cx < W && cy >= 0 && cy < H) {
      const unsigned long long k = p.keys[static_cast<long long>(cy) * W + cx];
      if (k != EMPTY) {
        row = static_cast<int>(k & 0xffffffffull);
        const float* s = p.data + static_cast<long long>(row) * COLS;
        const float3 pc = transform(T, s[0], s[1], s[2]);
        const float2 uv = project(p, pc);
        c = make_float4(uv.x, uv.y, pc.z, pixel_radius(p, s[RADIUS], pc.z));
      }
    }
    cand[i] = c;
    cand_row[i] = row;
  }
  __syncthreads();
  const int x = blockIdx.x * TILE_X + threadIdx.x, y = blockIdx.y * TILE_Y + threadIdx.y;
  if (x >= W || y >= H) return;
  const long long o = static_cast<long long>(y) * W + x;
  const int centre = (threadIdx.y + h) * tw + threadIdx.x + h;
  p.cell[o] = cand_row[centre];

  // the disk resolve: the nearest neighbouring winner whose disk covers the
  // pixel, cells in the op-by-op order (dy, then dx), strict <
  const float xf = static_cast<float>(x), yf = static_cast<float>(y);
  float best_z = FAR;
  int best = -1;
  for (int dy = -h; dy <= h; ++dy) {
    for (int dx = -h; dx <= h; ++dx) {
      const int i = centre + dy * tw + dx;
      if (cand_row[i] < 0) continue;  // no winner, or outside the image: never valid
      const float4 c = cand[i];
      const float du = c.x - xf, dv = c.y - yf;
      const bool covers = (du * du + dv * dv) <= c.w * c.w;
      if (c.z > 0.05f && c.z < p.depth_max && covers && c.z < best_z) {
        best_z = c.z;
        best = cand_row[i];
      }
    }
  }
  if (best < 0) {
    p.index[o] = -1;
    p.intensity[o] = 0.0f;
    p.depth[o] = 0.0f;
    p.time_out[o] = -1.0f;
    p.conf[o] = 0.0f;
#pragma unroll
    for (int k = 0; k < 3; ++k) p.vmap[3 * o + k] = p.nmap[3 * o + k] = p.color[3 * o + k] = 0.0f;
    return;
  }

  // the winner's attributes, as the op-by-op path's table row held them
  const float* s = p.data + static_cast<long long>(best) * COLS;
  const float3 pc = transform(T, s[0], s[1], s[2]);
  const float3 n = rotate(T, s[NORMAL], s[NORMAL + 1], s[NORMAL + 2]);
  const float r_px = pixel_radius(p, s[RADIUS], pc.z);
  // ray / tangent-plane depth refinement
  const float rx = (xf - p.cx) * p.inv_fx, ry = (yf - p.cy) * p.inv_fy;
  const float denom = sum3(rx * n.x, ry * n.y, 1.0f * n.z);
  const float z_plane = sum3(pc.x * n.x, pc.y * n.y, pc.z * n.z) /
                        (fabsf(denom) > 0.05f ? denom : INFINITY);
  const float z_c = pc.z;
  const float r_m = r_px * fmaxf(z_c, 1e-6f) * p.inv_fx;
  const float z = fabsf(z_plane - z_c) < 2.0f * r_m + 1e-3f ? z_plane : z_c;
  const float c0 = s[COLOR], c1 = s[COLOR + 1], c2 = s[COLOR + 2];
  p.index[o] = static_cast<long long>(static_cast<float>(best));  // the table held it as f32
  p.vmap[3 * o] = rx * z;
  p.vmap[3 * o + 1] = ry * z;
  p.vmap[3 * o + 2] = 1.0f * z;
  p.nmap[3 * o] = n.x;
  p.nmap[3 * o + 1] = n.y;
  p.nmap[3 * o + 2] = n.z;
  p.color[3 * o] = c0;
  p.color[3 * o + 1] = c1;
  p.color[3 * o + 2] = c2;
  p.intensity[o] = 0.299f * c0 + 0.587f * c1 + 0.114f * c2;
  p.depth[o] = z;
  p.time_out[o] = last_seen(s);
  p.conf[o] = s[CONF];
}

}  // namespace zbuffer

extern "C" {

// Bytes of `Params`, for the binding to check its mirror of the struct.
int zbuffer_params_bytes() { return static_cast<int>(sizeof(zbuffer::Params)); }

// The key buffer's memset, then the rows and the pixels passes, on `stream`
// of CUDA device `device`, without synchronising; returns the first
// cudaError_t (0 = launched).
int zbuffer_render_f32(const zbuffer::Params* params, int device, void* stream) {
  using namespace zbuffer;
  if (params == nullptr || params->width <= 0 || params->height <= 0 || params->half < 0 ||
      params->half > MAX_HALF || params->n_rows < 0 || params->n_rows > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  int current = 0;
  cudaError_t err = cudaGetDevice(&current);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (current != device && (err = cudaSetDevice(device)) != cudaSuccess) return static_cast<int>(err);
  const Params& p = *params;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int sms = 0;
  const long long pixels = static_cast<long long>(p.width) * p.height;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err == cudaSuccess) err = cudaMemsetAsync(p.keys, 0xff, pixels * sizeof(unsigned long long), s);
  if (err == cudaSuccess) {
    const long long needed = (p.n_rows + ROW_THREADS - 1) / ROW_THREADS;
    const long long most = static_cast<long long>(sms) * ROW_BLOCKS_PER_SM;
    const int blocks = static_cast<int>(needed < 1 ? 1 : (needed < most ? needed : most));
    rows_kernel<<<blocks, ROW_THREADS, 0, s>>>(p);
    err = cudaGetLastError();
  }
  if (err == cudaSuccess) {
    const dim3 grid((p.width + TILE_X - 1) / TILE_X, (p.height + TILE_Y - 1) / TILE_Y);
    pixels_kernel<<<grid, dim3(TILE_X, TILE_Y), 0, s>>>(p);
    err = cudaGetLastError();
  }
  if (current != device) cudaSetDevice(current);
  return static_cast<int>(err);
}

}  // extern "C"
