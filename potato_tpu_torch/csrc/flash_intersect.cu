// flash_intersect: closest triangle and closest sphere per ray over
// per-block front-to-back cluster queues.
//
// Replaces the Pallas TPU kernel of potato_tpu/ops/flash.py
// (_flash_raw -> _make_flash_kernel -> _process_block). It computes what
// that kernel computes; it is not carried over block by block.
//
// What bounds it on an H100: operations, not bytes. A (triangle, ray) pair
// costs about 50 flops and a (sphere, ray) pair about 30, on the fp32 CUDA
// cores; a ray moves 32 bytes in and 16 bytes out in all, and the feature
// tables are small enough to stay in L2. But a launch is short (2^15 rays,
// 8 warps' worth of rays an SM), and what it lasts is the walk of its
// longest queue: a CTA's visits follow one another, each warp meets a
// tile's rows one after the other, and most schedulers have nothing else to
// run. So the design spreads one ray's rows over several lanes, keeps the
// loop over rows free of branches, and keeps what happens between two
// visits short. Piece by piece:
//
// - Termination groups. The queues are built per block of `block` rays, but
//   a CTA takes only `group` consecutive rays of one block (`group` divides
//   `block`; both are launch parameters). It walks that block's queues and
//   takes far = max over ITS rays of min(best, t_max, sphere best) before
//   each visit. An entry distance is a lower bound for every ray of the
//   block, so a visit whose entry is not below the group's far improves no
//   ray of the group: every ray's result is what the whole block would give
//   it, no more visits are taken, and a launch has block / group times as
//   many CTAs. Because each queue is sorted by entry, the first refused
//   visit ends its phase.
// - Row slices. S lanes share a ray: lane slice s tests rows s, s + S, ...
//   of every tile against it, and each keeps its own running best. The S
//   lanes sit in one warp, 32 / S apart, so they meet by shuffle: a minimum
//   over slices inside the far reduction, and at the end of a phase a merge
//   that keeps the least t and, on an exact tie, the row that came first in
//   visit order (each best carries its `seq`), which is what one thread
//   walking all rows would have kept. A CTA's critical path falls by S and
//   the launch has S times the warps. With S <= 4 every quarter of a warp
//   reads one row, which is how shared memory serves a 16-byte load anyway.
//   S is a template parameter (row addresses become immediates); the
//   launcher takes 4, or the most below it that keeps the CTA within
//   MAX_THREADS (2 at groups of 512 rays, 1 at 1024).
// - RPT = 2 rays a thread (ray slots k * n_rt + rt of the group). A thread
//   keeps its rays (o, d, m = d x o, t_min, t_max) and each running best in
//   registers, reads a tile row from shared memory once and tests it against
//   all its rays: the shared memory loads per pair fall by that factor and a
//   warp has that many independent chains. A ray slot at or past `group` is
//   a dead lane.
// - Divide and square root only where a pair can hit, and after the loop.
//   Every pair gets its head: the edge values U, V, W, det and the sign test
//   (triangles), or half_b, c, delta (spheres). The loop over a thread's
//   rows does that and nothing else but note, one bit a row, which pairs can
//   hit; it has no branch, so rows overlap. The plane term, divide and range
//   test (the root, both t and the range tests) are then run for the noted
//   pairs only, each lane popping its own, lowest row first, until no lane
//   of the warp has one left: a warp pays as many tails as its busiest lane
//   needs, not one for every row in which some lane passed. The slot column
//   of a row is read only when the pair wins.
// - Bulk-async, double-buffered tiles. A parent tile (128 x 32
//   floats), a sphere cluster (128 x 8) and a child (16 x 32) are each one
//   contiguous 16-byte-aligned run, so one thread asks for each with
//   cp.async.bulk (no tensor map), completion counted in bytes on an
//   mbarrier. While visit j computes from one buffer, visit j + 1 is
//   already landing in the other; it is requested only if its entry is
//   below the current far, and a tile that arrives for a visit the
//   termination test then refuses is waited for and not consumed. The one
//   __syncthreads of the far reduction is also what frees a buffer.
//
// Order and semantics: sphere phase first (only when has_sph), its result
// bounding the triangle phases: their far, and the range of their pair
// tests (a triangle behind the ray's sphere hit is no hit, so a ray's
// triangle result does not depend on which visits its group took); packed child visits j < n_pk (sentinel
// child ids, == nsub, are skipped, never loaded); whole-parent tail visits
// j < n_tail. A group whose block has empty queues writes t = BIG, slot = 0.
//
// Ties: each ray keeps a strict `<` running minimum in visit order, so the
// first primitive visited that attains the minimum wins. The TPU kernel
// keeps a running best per tile row and extracts the lowest row at the end;
// on an exact tie in t between two distinct primitives the two may
// therefore name different (equally near) primitives.
//
// Arithmetic: the pair tests keep the expressions of the plain PyTorch
// version (ops/flash.py: _triangle_keys, _sphere_keys) term for term, and
// every rounding is fixed by hand (__fmaf_rn, __fmul_rn, __fadd_rn, ...):
// nothing is left for the compiler to contract, so every instantiation,
// at every group, returns the same floats. The sphere test rounds as the
// plain version does, product by product (sph_head says why), and so
// does a triangle's t (tri_finish); the triangle's edge values fuse their
// multiply-adds.
// U, V and W are one function, edge_value, used for every edge of every
// triangle and every ray. Triangles sharing an edge carry exactly negated
// features for it and rounding is symmetric in sign, so their edge values
// are exact negations: a ray crossing a shared edge is accepted by at least
// one triangle, as a property of this source. What a ray derives once (m,
// |d|^2) is rounded as the plain version rounds it. No
// fast-math; divisions and square roots are IEEE.

#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr int RPT = 2;          // rays a thread
constexpr int K = 128;          // rows of a parent / sphere cluster tile
constexpr int W = 16;           // rows of a child tile
constexpr int CPP = K / W;      // children per parent
constexpr int F = 32;           // floats per triangle row
constexpr int SLOT_COL = 24;    // global slot of the row, as f32
constexpr int SF = 8;           // floats per sphere row
constexpr float BIG = 3.0e38f;
constexpr int NBUF = 2;         // tile buffers of a CTA
constexpr int MAX_SLICES = 4;   // lanes of a warp that share a ray's rows
constexpr int MAX_THREADS = 512;   // of a CTA
constexpr int NO_SEQ = 0x7fffffff; // place in visit order of "nothing yet"
constexpr unsigned FULL = 0xffffffffu;

struct Ray {
  float ox, oy, oz, dx, dy, dz, mx, my, mz, t_min, t_max;
};

// What a ray derives once, rounded product by product and sum by sum as the
// plain version rounds it: a * b - c * d, and a dot product left to right.
__device__ __forceinline__ float cross_term(float a, float b, float c,
                                            float d) {
  return __fsub_rn(__fmul_rn(a, b), __fmul_rn(c, d));
}

__device__ __forceinline__ float dot3(float ax, float ay, float az, float bx,
                                      float by, float bz) {
  return __fadd_rn(__fadd_rn(__fmul_rn(ax, bx), __fmul_rn(ay, by)),
                   __fmul_rn(az, bz));
}

// ---- mbarrier and bulk copy (addresses are 32-bit shared-space)

__device__ __forceinline__ uint32_t shared_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_arrive_expect(uint32_t bar,
                                                   uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(bar), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
  } while (!done);
}

__device__ __forceinline__ void bulk_load(float* dst, const float* src,
                                          uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n"
      :: "r"(shared_addr(dst)),
         "l"(static_cast<unsigned long long>(__cvta_generic_to_global(src))),
         "r"(bytes), "r"(bar)
      : "memory");
}

// The tile buffers of a CTA and the state of their barriers. Every member
// is uniform over the CTA; every call below is made by all its threads.
struct Tiles {
  float* buf;          // NBUF buffers of K * F floats
  uint32_t bar;        // NBUF mbarriers, 8 bytes apart
  unsigned parity;     // bit b: the phase the next wait on buffer b awaits

  __device__ __forceinline__ float* at(int b) const { return buf + b * K * F; }

  // one contiguous run of `count` floats into buffer b
  __device__ __forceinline__ void fetch(int b, const float* __restrict__ src,
                                        int count) {
    if (threadIdx.x == 0) {
      mbar_arrive_expect(bar + 8 * b, count * 4);
      bulk_load(at(b), src, count * 4, bar + 8 * b);
    }
  }

  // the children of one packed visit (ids at `ids`, sentinel == nsub) into
  // buffer b, child k at rows k * W
  __device__ __forceinline__ void fetch_children(
      int b, const int* __restrict__ ids, int nsub,
      const float* __restrict__ tri_flat) {
    if (threadIdx.x < 32) {
      const int lane = threadIdx.x;
      const int ci = lane < CPP ? ids[lane] : nsub;
      const bool real = ci != nsub;
      const unsigned mask = __ballot_sync(FULL, real);
      if (lane == 0) mbar_arrive_expect(bar + 8 * b, __popc(mask) * W * F * 4);
      __syncwarp();
      if (real)
        bulk_load(at(b) + lane * W * F,
                  tri_flat + static_cast<size_t>(ci) * (W * F), W * F * 4,
                  bar + 8 * b);
    }
  }

  // returns once buffer b holds what was last fetched into it
  __device__ __forceinline__ void ready(int b) {
    mbar_wait(bar + 8 * b, (parity >> b) & 1u);
    parity ^= 1u << b;
  }
};

// A ray's running best: strict-< minimum of t, with the place in visit
// order (seq) and the slot of the primitive that attained it.
struct Best {
  float t;
  int seq, slot;
};

// Where a thread stands in its CTA. A warp is cut into S slices of 32 / S
// neighbouring lanes; a lane holds the ray slots k * n_rt + rt of the group
// (k < RPT) and tests them against the rows of its slice, so the S lanes
// that share a ray sit in one warp, 32 / S lanes apart, and meet through
// shuffles. With S <= 4 each quarter of a warp reads one row, which is how
// shared memory serves a 16-byte load anyway.
struct Seat {
  int rt, n_rt, slice;
  __device__ __forceinline__ int ray(int k) const { return k * n_rt + rt; }
};

// float -> int that keeps the order, so a warp-wide maximum is one redux
__device__ __forceinline__ int ordered_int(float f) {
  const int i = __float_as_int(f);
  return i ^ ((i >> 31) & 0x7fffffff);
}

__device__ __forceinline__ float ordered_float(int i) {
  return __int_as_float(i ^ ((i >> 31) & 0x7fffffff));
}

// far = max over the group's rays of min(best over all slices, cap); every
// thread returns the same value. Slices meet by shuffle, lanes by redux,
// warps through `partial` and one barrier; the partials alternate between
// two rows so that a call's writes cannot meet the reads of the call before
// it. That barrier also separates the visit before it from whatever is
// fetched after it.
template <int S>
__device__ __forceinline__ float group_far(const Best (&best)[RPT],
                                           const float (&cap)[RPT],
                                           float (*partial)[32], int& flip) {
  float v = -BIG;
#pragma unroll
  for (int k = 0; k < RPT; ++k) {
    float m = best[k].t;
#pragma unroll
    for (int o = 32 / S; o < 32; o <<= 1)
      m = fminf(m, __shfl_xor_sync(FULL, m, o));
    v = fmaxf(v, fminf(m, cap[k]));
  }
  v = ordered_float(__reduce_max_sync(FULL, ordered_int(v)));
  if ((threadIdx.x & 31) == 0) partial[flip][threadIdx.x >> 5] = v;
  __syncthreads();
  const int nw = blockDim.x >> 5;
  float r = partial[flip][0];
  for (int w = 1; w < nw; ++w) r = fmaxf(r, partial[flip][w]);
  flip ^= 1;
  return r;
}

// End of a phase: the slices of a ray agree on its best. The least t wins;
// on an exact tie the one found first in visit order (least seq), which is
// what one thread walking all rows with a strict `<` would keep. Every
// slice leaves with the merged best.
template <int S>
__device__ __forceinline__ void merge_slices(Best (&best)[RPT]) {
#pragma unroll
  for (int o = 32 / S; o < 32; o <<= 1) {
#pragma unroll
    for (int k = 0; k < RPT; ++k) {
      const float ot = __shfl_xor_sync(FULL, best[k].t, o);
      const int oq = __shfl_xor_sync(FULL, best[k].seq, o);
      const int os = __shfl_xor_sync(FULL, best[k].slot, o);
      if (ot < best[k].t || (ot == best[k].t && oq < best[k].seq)) {
        best[k].t = ot;
        best[k].seq = oq;
        best[k].slot = os;
      }
    }
  }
}

// The sheared edge function of one edge, a bilinear form of [d, m] with
// the row's six features for that edge. One multiply-add order for every
// edge, triangle and ray: see "Arithmetic" above.
__device__ __forceinline__ float edge_value(const Ray& r, float f0, float f1,
                                            float f2, float f3, float f4,
                                            float f5) {
  float u = __fmul_rn(r.dx, f0);
  u = __fmaf_rn(r.dy, f1, u);
  u = __fmaf_rn(r.dz, f2, u);
  u = __fmaf_rn(r.mx, f3, u);
  u = __fmaf_rn(r.my, f4, u);
  u = __fmaf_rn(r.mz, f5, u);
  return u;
}

// ---- one (triangle row, ray) pair

// The part every pair pays: edge values, det, sign test. True if the pair
// can hit (the ray's line crosses the triangle and det != 0).
__device__ __forceinline__ bool tri_head(const float4& a, const float4& b,
                                         const float4& c, const float4& d,
                                         const float4& e, const Ray& r,
                                         float& det) {
  // columns: a = 0..3, b = 4..7, c = 8..11, d = 12..15, e = 16..19
  const float U = edge_value(r, a.x, a.y, a.z, a.w, b.x, b.y);
  const float V = edge_value(r, b.z, b.w, c.x, c.y, c.z, c.w);
  const float Wf = edge_value(r, d.x, d.y, d.z, d.w, e.x, e.y);
  det = __fadd_rn(__fadd_rn(U, V), Wf);
  const bool same_sign = (U >= 0.0f && V >= 0.0f && Wf >= 0.0f) ||
                         (U <= 0.0f && V <= 0.0f && Wf <= 0.0f);
  return same_sign && det != 0.0f;
}

// The rest, for a pair that can hit: t from the plane through corner a, in
// a's frame, t = (a - o).n / d.n, then the range test and the running
// minimum. The slot column is read only when the pair wins. Every product
// and sum is rounded as the plain version rounds it. Not t = (o.n - a.n) /
// det: U, V and W are each the size of |a x b|, so for a ray far from the
// origin their sum keeps few of its bits, and a t divided by it put hit
// points up to 5e-2 off the plane of a box face 600 out; a bounce ray from
// there re-hit its own face from behind. A ray in the plane (d.n = 0) gets
// an infinite or NaN t, which the range test refuses.
__device__ __forceinline__ void tri_finish(const float* __restrict__ row,
                                           int seq, const Ray& r, Best& best) {
  // columns: e = 16..19 (n.x = e.z, n.y = e.w), f = 20..23 (n.z, a)
  const float4 e = reinterpret_cast<const float4*>(row)[4];
  const float4 f = reinterpret_cast<const float4*>(row)[5];
  const float p_n = __fadd_rn(
      __fadd_rn(__fmul_rn(__fsub_rn(f.y, r.ox), e.z),
                __fmul_rn(__fsub_rn(f.z, r.oy), e.w)),
      __fmul_rn(__fsub_rn(f.w, r.oz), f.x));
  const float d_n = __fadd_rn(
      __fadd_rn(__fmul_rn(r.dx, e.z), __fmul_rn(r.dy, e.w)),
      __fmul_rn(r.dz, f.x));
  const float tt = __fdiv_rn(p_n, d_n);
  const bool valid = tt >= r.t_min && tt <= r.t_max;
  const float key = valid ? tt : BIG;
  if (key < best.t) {
    best.t = key;
    best.seq = seq;
    best.slot = static_cast<int>(row[SLOT_COL]);
  }
}

// A noted pair, whole: its head again (for its sign test), then the rest.
__device__ __forceinline__ void tri_pair(const float* __restrict__ row,
                                         int seq, const Ray& r, Best& best) {
  const float4* q = reinterpret_cast<const float4*>(row);
  float det;
  if (tri_head(q[0], q[1], q[2], q[3], q[4], r, det))
    tri_finish(row, seq, r, best);
}

// ---- one (sphere row, ray) pair; half-b quadratic, two-root select

// what a ray keeps for the sphere phase beside itself
struct SphRay {
  float a_coef, inv_a;
};

// The part every pair pays: half_b, c, delta, in the sphere's own frame
// (oc = o - c, half_b = d.oc, c = oc.oc - r^2; the row carries r^2). True
// if the pair can hit (the ray's line meets a real sphere). Every product
// and sum is rounded as the plain version rounds it, with no fused
// multiply-add: a ray that starts on a sphere (every bounce off one) has c
// down at its rounding error, and that error alone decides whether the
// near root lands just above t_min, so kernel and plain version must
// round it alike to agree. (The expanded form |o|^2 - 2 o.c + |c|^2 - r^2
// cancels there: 30 % of the rays leaving the white spheres of
// next_week_final re-hit their own sphere from inside.)
__device__ __forceinline__ bool sph_head(const float4& s0, float ok_flag,
                                         const Ray& r, const SphRay& s,
                                         float& half_b, float& delta) {
  const float ocx = __fsub_rn(r.ox, s0.x);
  const float ocy = __fsub_rn(r.oy, s0.y);
  const float ocz = __fsub_rn(r.oz, s0.z);
  half_b = dot3(r.dx, r.dy, r.dz, ocx, ocy, ocz);
  const float c_coef = __fsub_rn(dot3(ocx, ocy, ocz, ocx, ocy, ocz), s0.w);
  delta = __fsub_rn(__fmul_rn(half_b, half_b), __fmul_rn(s.a_coef, c_coef));
  return delta > 0.0f && ok_flag > 0.5f;
}

// The rest, for a pair that can hit (delta > 0): root, both t, range
// tests, running minimum.
__device__ __forceinline__ void sph_finish(float half_b, float delta,
                                           int slot, int seq, const Ray& r,
                                           const SphRay& s, Best& best) {
  const float sqrt_delta = __fsqrt_rn(delta);
  const float tt0 = __fmul_rn(__fsub_rn(-half_b, sqrt_delta), s.inv_a);
  const float tt1 = __fmul_rn(__fadd_rn(-half_b, sqrt_delta), s.inv_a);
  const bool t0_ok = tt0 >= r.t_min && tt0 <= r.t_max;
  const bool t1_ok = tt1 >= r.t_min && tt1 <= r.t_max;
  const float st = t0_ok ? tt0 : tt1;
  const bool valid = t0_ok || t1_ok;
  const float key = valid ? st : BIG;
  if (key < best.t) {
    best.t = key;
    best.seq = seq;
    best.slot = slot;
  }
}

// A noted pair, whole: its head again (for half_b and delta), then the rest.
__device__ __forceinline__ void sph_pair(const float* __restrict__ row,
                                         int slot, int seq, const Ray& r,
                                         const SphRay& s, Best& best) {
  float half_b, delta;
  if (sph_head(reinterpret_cast<const float4*>(row)[0], row[4], r, s, half_b,
               delta))
    sph_finish(half_b, delta, slot, seq, r, s, best);
}

// ---- a thread's rows of one tile against its rays
//
// A first loop gives every pair its head and only notes, one bit a row,
// which pairs can hit; it has no branch, so rows overlap. A
// second loop then finishes the noted pairs, each lane its own, lowest row
// first (so a ray still meets its rows in visit order), until no lane of
// the warp has one left: the divides and roots paid are the most any one
// lane needs, not one for every row in which some lane passed.

// True while some lane of the warp has a noted pair left.
__device__ __forceinline__ bool any_noted(const unsigned (&cand)[RPT]) {
  unsigned left = 0u;
#pragma unroll
  for (int k = 0; k < RPT; ++k) left |= cand[k];
  return __any_sync(FULL, left != 0u);
}

// Takes the lowest noted row off `cand`.
__device__ __forceinline__ int pop_noted(unsigned& cand) {
  const int i = __ffs(cand) - 1;
  cand &= cand - 1u;
  return i;
}

// Sphere cluster `ci` in `tile`, visit number `visit`: rows slice, slice +
// S, ... of its K.
template <int S>
__device__ __forceinline__ void sph_rows(const float* __restrict__ tile,
                                         int ci, int visit, int slice,
                                         const Ray (&r)[RPT],
                                         const SphRay (&s)[RPT],
                                         Best (&best)[RPT]) {
  constexpr int N = K / S;              // rows a thread tests
  constexpr int STEP = N < 32 ? N : 32; // rows noted in one word
  for (int i0 = 0; i0 < N; i0 += STEP) {
    unsigned cand[RPT];
#pragma unroll
    for (int k = 0; k < RPT; ++k) cand[k] = 0u;
#pragma unroll 4
    for (int i = 0; i < STEP; ++i) {
      const float* row = tile + (slice + S * (i0 + i)) * SF;
      const float4 s0 = reinterpret_cast<const float4*>(row)[0];
      const float ok_flag = row[4];
#pragma unroll
      for (int k = 0; k < RPT; ++k) {
        float half_b, delta;
        const bool pass = sph_head(s0, ok_flag, r[k], s[k], half_b, delta);
        cand[k] |= (pass ? 1u : 0u) << i;
      }
    }
    while (any_noted(cand)) {
#pragma unroll
      for (int k = 0; k < RPT; ++k) {
        if (cand[k] != 0u) {
          const int p = slice + S * (i0 + pop_noted(cand[k]));
          sph_pair(tile + p * SF, ci * K + p, visit * K + p, r[k], s[k],
                   best[k]);
        }
      }
    }
  }
}

// Triangle tile of CPP children of W rows (bit c of `children`: child c is
// there), visit number `visit`: rows slice, slice + S, ... of each child.
template <int S>
__device__ __forceinline__ void tri_rows(const float* __restrict__ tile,
                                         unsigned children, int visit,
                                         int slice, const Ray (&r)[RPT],
                                         Best (&best)[RPT]) {
  constexpr int PER_CHILD = W / S;      // rows of a child a thread tests
  // children noted in one word
  constexpr int STEP = 32 / PER_CHILD < CPP ? 32 / PER_CHILD : CPP;
  for (int c0 = 0; c0 < CPP; c0 += STEP) {
    unsigned cand[RPT];
#pragma unroll
    for (int k = 0; k < RPT; ++k) cand[k] = 0u;
    for (int c = 0; c < STEP; ++c) {
      if (!((children >> (c0 + c)) & 1u)) continue;
#pragma unroll 2
      for (int ii = 0; ii < PER_CHILD; ++ii) {
        const float4* q = reinterpret_cast<const float4*>(
            tile + ((c0 + c) * W + slice + S * ii) * F);
        const float4 a = q[0], b = q[1], cc = q[2], d = q[3], e = q[4];
#pragma unroll
        for (int k = 0; k < RPT; ++k) {
          float det;
          const bool pass = tri_head(a, b, cc, d, e, r[k], det);
          cand[k] |= (pass ? 1u : 0u) << (c * PER_CHILD + ii);
        }
      }
    }
    while (any_noted(cand)) {
#pragma unroll
      for (int k = 0; k < RPT; ++k) {
        if (cand[k] != 0u) {
          const int i = pop_noted(cand[k]);
          const int p =
              (c0 + i / PER_CHILD) * W + slice + S * (i % PER_CHILD);
          tri_pair(tile + p * F, visit * K + p, r[k], best[k]);
        }
      }
    }
  }
}

// S: the slices a CTA's threads stand in; slice s takes rows s, s + S, ...
template <int S>
__global__ void __launch_bounds__(MAX_THREADS, 1) flash_intersect_kernel(
    const float* __restrict__ rays, int bp, int block, int group,
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
  __shared__ __align__(128) float tile_mem[NBUF * K * F];
  __shared__ __align__(8) unsigned long long bar_mem[NBUF];
  __shared__ float partial[2][32];

  const int tid = threadIdx.x;
  const int first = blockIdx.x * group;   // first ray of this group
  const int blk = first / block;          // the queue block it belongs to

  Seat seat;
  seat.n_rt = blockDim.x / S;
  seat.rt = (tid >> 5) * (32 / S) + (tid & 31) % (32 / S);
  seat.slice = (tid & 31) / (32 / S);
  int flip = 0;

  Tiles tiles;
  tiles.buf = tile_mem;
  tiles.bar = shared_addr(bar_mem);
  tiles.parity = 0u;
  if (tid == 0) {
    for (int b = 0; b < NBUF; ++b) mbar_init(tiles.bar + 8 * b, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  Ray r[RPT];
  bool live[RPT];
#pragma unroll
  for (int k = 0; k < RPT; ++k) {
    live[k] = seat.ray(k) < group;
    const int i = first + (live[k] ? seat.ray(k) : 0);
    r[k].ox = rays[0 * bp + i];
    r[k].oy = rays[1 * bp + i];
    r[k].oz = rays[2 * bp + i];
    r[k].dx = rays[3 * bp + i];
    r[k].dy = rays[4 * bp + i];
    r[k].dz = rays[5 * bp + i];
    r[k].t_min = rays[6 * bp + i];
    // a ray slot past the group is a dead lane: nothing lies in its range
    r[k].t_max = live[k] ? rays[7 * bp + i] : -BIG;
    r[k].mx = cross_term(r[k].dy, r[k].oz, r[k].dz, r[k].oy);
    r[k].my = cross_term(r[k].dz, r[k].ox, r[k].dx, r[k].oz);
    r[k].mz = cross_term(r[k].dx, r[k].oy, r[k].dy, r[k].ox);
  }
  // every slice leaves a phase with the merged result; slice 0 writes it
#pragma unroll
  for (int k = 0; k < RPT; ++k) live[k] = live[k] && seat.slice == 0;

  int seen_sph = 0, seen_child = 0, seen_tail = 0;

  // ---------------- sphere phase ----------------
  // cap: what bounds a ray's triangle search from outside, min(t_max,
  // sphere best)
  float cap[RPT];
#pragma unroll
  for (int k = 0; k < RPT; ++k) cap[k] = r[k].t_max;
  {
    Best s_best[RPT];
#pragma unroll
    for (int k = 0; k < RPT; ++k) s_best[k] = {BIG, NO_SEQ, 0};
    if (has_sph) {
      SphRay s[RPT];
#pragma unroll
      for (int k = 0; k < RPT; ++k) {
        s[k].a_coef = dot3(r[k].dx, r[k].dy, r[k].dz, r[k].dx, r[k].dy,
                           r[k].dz);
        s[k].inv_a = __fdiv_rn(1.0f, s[k].a_coef);
      }
      const int n = min(n_sph[blk], cs);
      const int* ids = sph_ids + static_cast<size_t>(blk) * cs;
      const float* entry = sph_entry + static_cast<size_t>(blk) * cs;
      float e_cur = n > 0 ? entry[0] : BIG;
      bool ahead = false;      // visit j's tile was asked for during j - 1
      int j = 0;
      for (; j < n; ++j) {
        const float e_next = j + 1 < n ? entry[j + 1] : BIG;
        const float far = group_far<S>(s_best, cap, partial, flip);
        if (!(e_cur < far)) break;
        const int ci = ids[j];
        const int b = j & (NBUF - 1);
        if (!ahead)
          tiles.fetch(b, sph_feats + static_cast<size_t>(ci) * (K * SF),
                      K * SF);
        ahead = e_next < far;
        if (ahead)
          tiles.fetch(b ^ 1,
                      sph_feats + static_cast<size_t>(ids[j + 1]) * (K * SF),
                      K * SF);
        tiles.ready(b);
        ++seen_sph;
        sph_rows<S>(tiles.at(b), ci, j, seat.slice, r, s, s_best);
        e_cur = e_next;
      }
      if (ahead) tiles.ready(j & (NBUF - 1));   // asked for, not consumed
      merge_slices<S>(s_best);
    }
#pragma unroll
    for (int k = 0; k < RPT; ++k) {
      if (live[k]) {
        sph_t[first + seat.ray(k)] = s_best[k].t;
        sph_slot[first + seat.ray(k)] = s_best[k].slot;
      }
      cap[k] = fminf(cap[k], s_best[k].t);
      r[k].t_max = cap[k];
    }
  }

  // ---------------- triangle phases ----------------
  Best t_best[RPT];
#pragma unroll
  for (int k = 0; k < RPT; ++k) t_best[k] = {BIG, NO_SEQ, 0};
  int visit_no = 0;     // triangle visits consumed so far, both phases

  // packed visits: CPP children of W rows each
  {
    const int n = min(n_pk[blk], v_cap);
    const int* ids = child_ids + static_cast<size_t>(blk) * (v_cap * CPP);
    const float* entry = pk_entry + static_cast<size_t>(blk) * v_cap;
    float e_cur = n > 0 ? entry[0] : BIG;
    bool ahead = false;
    int j = 0;
    for (; j < n; ++j) {
      const float e_next = j + 1 < n ? entry[j + 1] : BIG;
      unsigned real = 0u;     // bit k: child k of this visit is no sentinel
#pragma unroll
      for (int k = 0; k < CPP; ++k)
        real |= (ids[j * CPP + k] != nsub ? 1u : 0u) << k;
      const float far = group_far<S>(t_best, cap, partial, flip);
      if (!(e_cur < far)) break;
      const int b = j & (NBUF - 1);
      if (!ahead) tiles.fetch_children(b, ids + j * CPP, nsub, tri_flat);
      ahead = e_next < far;
      if (ahead)
        tiles.fetch_children(b ^ 1, ids + (j + 1) * CPP, nsub, tri_flat);
      tiles.ready(b);
      seen_child += __popc(real);
      tri_rows<S>(tiles.at(b), real, visit_no, seat.slice, r, t_best);
      ++visit_no;
      e_cur = e_next;
    }
    if (ahead) tiles.ready(j & (NBUF - 1));
  }

  // tail visits: whole parents of K rows
  {
    const int n = min(n_tail[blk], tail_cap);
    const int* ids = tail_ids + static_cast<size_t>(blk) * tail_cap;
    const float* entry = tail_entry + static_cast<size_t>(blk) * tail_cap;
    float e_cur = n > 0 ? entry[0] : BIG;
    bool ahead = false;
    int j = 0;
    for (; j < n; ++j) {
      const float e_next = j + 1 < n ? entry[j + 1] : BIG;
      const float far = group_far<S>(t_best, cap, partial, flip);
      if (!(e_cur < far)) break;
      const int b = j & (NBUF - 1);
      if (!ahead)
        tiles.fetch(b, tri_flat + static_cast<size_t>(ids[j]) * (K * F),
                    K * F);
      ahead = e_next < far;
      if (ahead)
        tiles.fetch(b ^ 1,
                    tri_flat + static_cast<size_t>(ids[j + 1]) * (K * F),
                    K * F);
      tiles.ready(b);
      ++seen_tail;
      tri_rows<S>(tiles.at(b), 0xffu, visit_no, seat.slice, r, t_best);
      ++visit_no;
      e_cur = e_next;
    }
    if (ahead) tiles.ready(j & (NBUF - 1));
  }
  merge_slices<S>(t_best);

#pragma unroll
  for (int k = 0; k < RPT; ++k) {
    if (live[k]) {
      tri_t[first + seat.ray(k)] = t_best[k].t;
      tri_slot[first + seat.ray(k)] = t_best[k].slot;
    }
  }
  if (visits != nullptr && tid == 0) {
    visits[blockIdx.x * 3 + 0] = seen_sph;
    visits[blockIdx.x * 3 + 1] = seen_child;
    visits[blockIdx.x * 3 + 2] = seen_tail;
  }
}

}  // namespace

// Rays a thread holds.
extern "C" int flash_intersect_rays_per_thread() { return RPT; }

// One CTA per group of `group` consecutive rays (group divides block, block
// divides bp): the ray threads, rounded up to whole warps, times the most
// slices, up to MAX_SLICES, that keep the CTA within MAX_THREADS. Launches
// on `stream` without synchronising; returns cudaGetLastError(), or
// cudaErrorInvalidValue for a group that no CTA holds.
extern "C" int flash_intersect_launch(
    const float* rays, int bp, int block, int group,
    const int* n_pk, const int* n_tail, const int* n_sph,
    const int* child_ids, const float* pk_entry, int v_cap,
    const int* tail_ids, const float* tail_entry, int tail_cap,
    const int* sph_ids, const float* sph_entry, int cs,
    const float* tri_flat, int nsub, const float* sph_feats, int has_sph,
    float* tri_t, int* tri_slot, float* sph_t, int* sph_slot,
    int* visits, void* stream) {
  if (group < 1) return static_cast<int>(cudaErrorInvalidValue);
  const int ray_threads = ((group + RPT - 1) / RPT + 31) / 32 * 32;
  if (ray_threads > MAX_THREADS) return static_cast<int>(cudaErrorInvalidValue);
  int slices = MAX_SLICES;
  while (ray_threads * slices > MAX_THREADS) slices /= 2;
  auto kernel = flash_intersect_kernel<MAX_SLICES>;
  if (slices == 2) kernel = flash_intersect_kernel<2>;
  if (slices == 1) kernel = flash_intersect_kernel<1>;
  kernel<<<bp / group, ray_threads * slices, 0,
           static_cast<cudaStream_t>(stream)>>>(
      rays, bp, block, group, n_pk, n_tail, n_sph, child_ids, pk_entry,
      v_cap, tail_ids, tail_entry, tail_cap, sph_ids, sph_entry, cs,
      tri_flat, nsub, sph_feats, has_sph, tri_t, tri_slot, sph_t, sph_slot,
      visits);
  return static_cast<int>(cudaGetLastError());
}
