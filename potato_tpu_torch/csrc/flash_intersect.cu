// flash_intersect: closest triangle and closest sphere per ray over
// per-block front-to-back cluster queues.
//
// Replaces the Pallas TPU kernel of potato_tpu/ops/flash.py
// (_flash_raw -> _make_flash_kernel -> _process_block). It computes what
// that kernel computes; it is not carried over block by block.
//
// Shape: one CTA per block of rays, one ray per thread (blockDim.x = rays
// per block, a launch parameter). A thread keeps its ray (o, d, m = d x o,
// t_min, t_max) and its running best (t, slot) for triangles and for
// spheres in registers. Per visit, the cluster's feature tile (16 rows x
// 32 floats per child, 128 x 32 per parent, 128 x 8 per sphere cluster) is
// staged through shared memory with coalesced loads, then every thread
// tests its ray against each row; all threads of a warp read the same row,
// so shared memory serves it as a broadcast.
//
// Order and semantics: sphere phase first (only when has_sph), its result
// bounding the triangle phases; packed child visits j < n_pk (sentinel
// child ids, == nsub, are skipped); whole-parent tail visits j < n_tail.
// Before each visit the block takes far = max over rays of min(best,
// t_max, sphere best); a visit whose entry distance is not below far
// cannot improve any ray, and because each queue is sorted by entry the
// first such visit ends its phase. A block with empty queues writes
// t = BIG, slot = 0.
//
// Ties: each thread keeps a strict `<` running minimum, so the first
// primitive visited that attains the minimum wins. The TPU kernel keeps a
// running best per tile row and extracts the lowest row at the end; on an
// exact tie in t between two distinct primitives the two may therefore
// name different (equally near) primitives.
//
// Arithmetic: the pair tests keep the expressions of the plain PyTorch
// version (ops/flash.py: _triangle_keys, _sphere_keys) term for term. U, V
// and W are the same bilinear forms of [d, m] for every triangle, and
// triangles sharing an edge carry exactly negated features for it, so
// their edge values are exact negations under any fixed FMA contraction:
// a ray crossing a shared edge is accepted by at least one triangle. No
// fast-math; divisions and square roots are IEEE.
//
// Bound on an H100: operations, not bytes. A (triangle, ray) pair costs
// about 50 flops and a (sphere, ray) pair about 30, on the fp32 CUDA cores;
// a ray moves 32 bytes in and 16 bytes out in all, and the feature tables
// are small enough to stay in L2. The design so far does nothing beyond
// registers for the ray state and shared-memory broadcast of the tiles;
// asynchronous staging (cp.async / TMA), several rays per thread and a
// grid that fills all SMs at small batch are left for later.

#include <cuda_runtime.h>

namespace {

constexpr int K = 128;          // rows of a parent / sphere cluster tile
constexpr int W = 16;           // rows of a child tile
constexpr int CPP = K / W;      // children per parent
constexpr int F = 32;           // floats per triangle row
constexpr int SLOT_COL = 24;    // global slot of the row, as f32
constexpr int SF = 8;           // floats per sphere row
constexpr float BIG = 3.0e38f;

// max over the block; every thread returns the same value
__device__ __forceinline__ float block_max(float v, float* scratch) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  const int warp = threadIdx.x >> 5;
  __syncthreads();  // scratch (and the tile) may still be read by others
  if ((threadIdx.x & 31) == 0) scratch[warp] = v;
  __syncthreads();
  const int nw = blockDim.x >> 5;
  float r = scratch[0];
  for (int w = 1; w < nw; ++w) r = fmaxf(r, scratch[w]);
  return r;
}

struct Ray {
  float ox, oy, oz, dx, dy, dz, mx, my, mz, t_min, t_max;
};

// one triangle row against one ray; strict-< running minimum
__device__ __forceinline__ void tri_test(const float* __restrict__ row,
                                         const Ray& r, float& best_t,
                                         int& best_slot) {
  const float4* q = reinterpret_cast<const float4*>(row);
  const float4 a = q[0], b = q[1], c = q[2], d = q[3], e = q[4], f = q[5];
  // columns: a = 0..3, b = 4..7, c = 8..11, d = 12..15, e = 16..19,
  // f = 20..23
  const float U = r.dx * a.x + r.dy * a.y + r.dz * a.z
                + r.mx * a.w + r.my * b.x + r.mz * b.y;
  const float V = r.dx * b.z + r.dy * b.w + r.dz * c.x
                + r.mx * c.y + r.my * c.z + r.mz * c.w;
  const float Wf = r.dx * d.x + r.dy * d.y + r.dz * d.z
                 + r.mx * d.w + r.my * e.x + r.mz * e.y;
  const float det = U + V + Wf;
  const bool same_sign = (U >= 0.0f && V >= 0.0f && Wf >= 0.0f) ||
                         (U <= 0.0f && V <= 0.0f && Wf <= 0.0f);
  const bool det_ok = det != 0.0f;
  const float inv_det = (det_ok ? 1.0f : 0.0f) / (det_ok ? det : 1.0f);
  const float o_n = r.ox * e.z + r.oy * e.w + r.oz * f.x;
  const float tt = (o_n - f.y) * inv_det;
  const bool valid = det_ok && same_sign && tt >= r.t_min && tt <= r.t_max;
  const float key = valid ? tt : BIG;
  if (key < best_t) {
    best_t = key;
    best_slot = static_cast<int>(row[SLOT_COL]);
  }
}

__global__ void flash_intersect_kernel(
    const float* __restrict__ rays, int bp,
    const int* __restrict__ n_pk, const int* __restrict__ n_tail,
    const int* __restrict__ n_sph,
    const int* __restrict__ child_ids, const float* __restrict__ pk_entry,
    int v_cap,
    const int* __restrict__ tail_ids, const float* __restrict__ tail_entry,
    int tail_cap,
    const int* __restrict__ sph_ids, const float* __restrict__ sph_entry,
    int cs,
    const float* __restrict__ tri_flat, int nsub,
    const float* __restrict__ sph_feats, int has_sph,
    float* __restrict__ tri_t, int* __restrict__ tri_slot,
    float* __restrict__ sph_t, int* __restrict__ sph_slot,
    int* __restrict__ visits) {
  __shared__ __align__(16) float tile[K * F];
  __shared__ float scratch[32];
  __shared__ int cids[CPP];

  const int blk = blockIdx.x;
  const int tid = threadIdx.x;
  const int nthr = blockDim.x;
  const int i = blk * nthr + tid;

  Ray r;
  r.ox = rays[0 * bp + i];
  r.oy = rays[1 * bp + i];
  r.oz = rays[2 * bp + i];
  r.dx = rays[3 * bp + i];
  r.dy = rays[4 * bp + i];
  r.dz = rays[5 * bp + i];
  r.t_min = rays[6 * bp + i];
  r.t_max = rays[7 * bp + i];
  r.mx = r.dy * r.oz - r.dz * r.oy;
  r.my = r.dz * r.ox - r.dx * r.oz;
  r.mz = r.dx * r.oy - r.dy * r.ox;

  int seen_sph = 0, seen_child = 0, seen_tail = 0;

  // ---------------- sphere phase ----------------
  float s_best = BIG;
  int s_slot = 0;
  if (has_sph) {
    const int n = min(n_sph[blk], cs);
    const float a_coef = r.dx * r.dx + r.dy * r.dy + r.dz * r.dz;
    const float inv_a = 1.0f / a_coef;
    const float o2 = r.ox * r.ox + r.oy * r.oy + r.oz * r.oz;
    const float d_o = r.dx * r.ox + r.dy * r.oy + r.dz * r.oz;
    for (int j = 0; j < n; ++j) {
      const float far = block_max(fminf(s_best, r.t_max), scratch);
      if (!(sph_entry[blk * cs + j] < far)) break;
      const int ci = sph_ids[blk * cs + j];
      const float* src = sph_feats + static_cast<size_t>(ci) * K * SF;
      // (block_max's barrier already separates this store from the
      // previous visit's reads)
      for (int x = tid; x < K * SF; x += nthr) tile[x] = src[x];
      __syncthreads();
      ++seen_sph;
      for (int p = 0; p < K; ++p) {
        const float4 s0 = reinterpret_cast<const float4*>(tile + p * SF)[0];
        const float ok_flag = tile[p * SF + 4];
        const float cx = s0.x, cy = s0.y, cz = s0.z, cc = s0.w;
        // half-b quadratic, two-root select
        const float half_b = d_o - (r.dx * cx + r.dy * cy + r.dz * cz);
        const float c_coef =
            o2 - 2.0f * (r.ox * cx + r.oy * cy + r.oz * cz) + cc;
        const float delta = half_b * half_b - a_coef * c_coef;
        const bool sph_ok = delta > 0.0f && ok_flag > 0.5f;
        const float sqrt_delta = sqrtf(sph_ok ? delta : 1.0f);
        const float tt0 = (-half_b - sqrt_delta) * inv_a;
        const float tt1 = (-half_b + sqrt_delta) * inv_a;
        const bool t0_ok = tt0 >= r.t_min && tt0 <= r.t_max;
        const bool t1_ok = tt1 >= r.t_min && tt1 <= r.t_max;
        const float st = t0_ok ? tt0 : tt1;
        const bool valid = sph_ok && (t0_ok || t1_ok);
        const float key = valid ? st : BIG;
        if (key < s_best) {
          s_best = key;
          s_slot = ci * K + p;
        }
      }
    }
  }

  // ---------------- triangle phases ----------------
  float t_best = BIG;
  int t_slot = 0;

  // packed visits: CPP children of W rows each
  const int npk = min(n_pk[blk], v_cap);
  for (int j = 0; j < npk; ++j) {
    const float far =
        block_max(fminf(fminf(t_best, r.t_max), s_best), scratch);
    if (!(pk_entry[blk * v_cap + j] < far)) break;
    if (tid < CPP) cids[tid] = child_ids[blk * (v_cap * CPP) + j * CPP + tid];
    __syncthreads();
    for (int x = tid; x < K * F; x += nthr) {
      const int k = x / (W * F);
      const int ci = cids[k];
      if (ci != nsub)
        tile[x] = tri_flat[static_cast<size_t>(ci) * (W * F) + (x - k * W * F)];
    }
    __syncthreads();
    for (int k = 0; k < CPP; ++k) {
      if (cids[k] == nsub) continue;   // sentinel child: nothing to test
      ++seen_child;
      const float* base = tile + k * W * F;
#pragma unroll 4
      for (int p = 0; p < W; ++p) tri_test(base + p * F, r, t_best, t_slot);
    }
  }

  // tail visits: whole parents of K rows
  const int ntail = min(n_tail[blk], tail_cap);
  for (int j = 0; j < ntail; ++j) {
    const float far =
        block_max(fminf(fminf(t_best, r.t_max), s_best), scratch);
    if (!(tail_entry[blk * tail_cap + j] < far)) break;
    const int pid = tail_ids[blk * tail_cap + j];
    const float* src = tri_flat + static_cast<size_t>(pid) * (K * F);
    for (int x = tid; x < K * F; x += nthr) tile[x] = src[x];
    __syncthreads();
    ++seen_tail;
#pragma unroll 4
    for (int p = 0; p < K; ++p) tri_test(tile + p * F, r, t_best, t_slot);
  }

  tri_t[i] = t_best;
  tri_slot[i] = t_slot;
  sph_t[i] = s_best;
  sph_slot[i] = s_slot;
  if (visits != nullptr && tid == 0) {
    visits[blk * 3 + 0] = seen_sph;
    visits[blk * 3 + 1] = seen_child;
    visits[blk * 3 + 2] = seen_tail;
  }
}

}  // namespace

// Launches on `stream` without synchronising; returns cudaGetLastError().
extern "C" int flash_intersect_launch(
    const float* rays, int bp, int nb, int threads,
    const int* n_pk, const int* n_tail, const int* n_sph,
    const int* child_ids, const float* pk_entry, int v_cap,
    const int* tail_ids, const float* tail_entry, int tail_cap,
    const int* sph_ids, const float* sph_entry, int cs,
    const float* tri_flat, int nsub, const float* sph_feats, int has_sph,
    float* tri_t, int* tri_slot, float* sph_t, int* sph_slot,
    int* visits, void* stream) {
  flash_intersect_kernel<<<nb, threads, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      rays, bp, n_pk, n_tail, n_sph, child_ids, pk_entry, v_cap, tail_ids,
      tail_entry, tail_cap, sph_ids, sph_entry, cs, tri_flat, nsub,
      sph_feats, has_sph, tri_t, tri_slot, sph_t, sph_slot, visits);
  return static_cast<int>(cudaGetLastError());
}
