// The actor MLP of the rollout kernels' policy mode (K4 in
// cartpole_kernels.cu, K5 in quad_kernels.cu). Replaces _mlp_fwd and
// _policy_mean of safe_control_gym_tpu/ops/rollout_kernels.py, which ran the
// actor as three MXU dots on the TPU's (rows, B) lane layout.
//
// What it computes, per env and control step, from the state s at the start
// of the step:
//   obs = clip((s - nmean) * ninv, -clip_obs, clip_obs)
//   h1  = act(W1^T obs + b1)        act = tanh or relu
//   h2  = act(W2^T h1 + b2)
//   mu  = W3^T h2 + b3              (only the first nu of nu_out rows)
// The weights are one float32 buffer [nmean (nx), ninv (nx), W1 (nx, H1),
// b1 (H1), W2 (H1, H2), b2 (H2), W3 (H2, nu_out), b3 (nu_out)], in-major, so
// W[k][j] is at k * n_out + j.
//
// Design. One block of kPolicyThreads (256) threads serves a tile of
// kPolicyEnvs (32) envs. The threads of warp 0 run each env's step outside
// the actor, one thread per env with the state in registers, and write the
// env's obs to shared memory as [k][e]. Then all 256 threads run the actor as
// three small products on shared memory: layers 1 and 2 give each thread a
// register tile of RE envs x RU units (4 x 8, 4 x 4 or 2 x 4, the largest that
// still gives every thread a tile), read as float4 / float2 rows of the [k][e]
// activations and the [k][u] weights, and store [u][e]; the last layer gives
// each of E x nu threads one output. Warp 0 then reads mu and steps its envs.
// The weights live in shared memory: W1, W3's first nu columns and the
// biases always, W2 too where the whole block fits in the 227 KB a block may
// use (every width up to 128). Otherwise (SAC, 256 wide: W2 alone is 256 KB)
// W2 streams through a ring of two tiles of w2_rows (8, 16 or 32) rows by
// w2_cols columns, copied with 16-byte cp.async by the whole block: the ring
// runs over W2's tiles endlessly, so the next step's first two tiles load
// while warp 0 steps the physics. Where even the h2 activations of H2 units
// do not fit (H2 above about 750 at H1 = 384), layers 2 and 3 run in chunks
// of w2_cols units of H2 (the last one narrower), b2's and W3's rows of each
// chunk staged as it starts, and each mu keeps its sum across the chunks:
// the kernels' CHUNKED instantiation, so that the one-chunk code of every
// narrower actor keeps its registers and schedule.
//
// Bound. At H = 256 the actor is about 139k flop per env-step against about
// 2k of physics, so the policy mode is bound by float32 operations. Without
// fused multiply-adds (below) each multiply-add is two instructions, so the
// kernel can at best take twice the operations bound, its float32 ceiling.
// Measured on an H100 at B = 4096 (chip_smoke.py, PERF.md): 39-48% of that
// ceiling at 256 wide, 35-44 us a step; at 64 wide the env's serial chain,
// run by warp 0 alone, takes most of the step.
//
// Numerics. Full float32, no tensor cores, no split sums. One thread owns each
// output (env, unit) and accumulates it from 0.0 in ascending input order, one
// multiply and one add at a time (the files are built with --fmad=false), then
// adds the bias and takes the activation: the order of the plain version in
// ops/rollout_kernels.py (policy_mean_plain), so both give the same floats.
// The chunks of H2 run in ascending order, so mu's sums keep that order.

#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace scg {

// The policy kernels' block: kPolicyThreads threads for kPolicyEnvs envs
// (ops/rollout_kernels.py _POLICY_THREADS, _POLICY_ENVS).
constexpr int kPolicyThreads = 256;
constexpr int kPolicyEnvs = 32;

struct PolicyMLP {
  const float* p;  // the packed buffer
  int h1, h2, nu_out;
  float clip_obs;
  bool relu;
};

__device__ __forceinline__ float policy_act(float x, bool relu) {
  return relu ? fmaxf(x, 0.0f) : tanhf(x);
}

__host__ __device__ inline int round4(int n) { return (n + 3) / 4 * 4; }

// W2 stays in shared memory whole when its tile is all of it; otherwise it
// streams in tiles of w2_rows rows by w2_cols columns.
__host__ __device__ inline bool policy_w2_resident(int h1, int h2, int w2_rows, int w2_cols) {
  return w2_rows == h1 && w2_cols == h2;
}

// The dynamic shared memory of a policy launch, in floats from its start:
// every region rounded up to 4 floats so that each starts 16-byte aligned
// (ops/rollout_kernels.py _policy_smem_bytes computes the same). b2, W3 and
// h2 hold one chunk of w2_cols units of H2.
struct PolicyLayout {
  int w2, w1, b1, b2, w3, b3, nmean, ninv, obs, h1, h2, mu, total;
  __host__ __device__ PolicyLayout(int nx, int nu, int n1, int n2, int w2_rows, int w2_cols) {
    int off = 0;
    const bool resident = policy_w2_resident(n1, n2, w2_rows, w2_cols);
    w2 = off; off += round4(resident ? n1 * n2 : 2 * w2_rows * w2_cols);
    w1 = off; off += round4(nx * n1);
    b1 = off; off += round4(n1);
    b2 = off; off += round4(w2_cols);
    w3 = off; off += round4(w2_cols * nu);
    b3 = off; off += round4(nu);
    nmean = off; off += round4(nx);
    ninv = off; off += round4(nx);
    obs = off; off += round4(nx * kPolicyEnvs);
    h1 = off; off += round4(n1 * kPolicyEnvs);
    h2 = off; off += round4(w2_cols * kPolicyEnvs);
    mu = off; off += round4(nu * kPolicyEnvs);
    total = off;
  }
  __host__ __device__ size_t bytes() const { return (size_t)total * sizeof(float); }
};

// Float offset of W2 in the packed buffer.
__host__ __device__ inline int policy_w2_offset(int nx, int h1) {
  return 2 * nx + nx * h1 + h1;
}

// Whether a launch's geometry is one the kernels run: a ring's tiles divide
// H1, are 8 to H2 columns wide in eighths, and start 16-byte aligned in the
// packed buffer.
inline bool policy_geometry_ok(const void* p, int nx, int nu, int h1, int h2, int w2_rows,
                               int w2_cols, int envs, int threads, int smem) {
  if (envs != kPolicyEnvs || threads != kPolicyThreads || h1 % 8 || h2 % 8) return false;
  if (w2_cols <= 0 || w2_cols > h2 || w2_cols % 8) return false;
  if ((size_t)smem != PolicyLayout(nx, nu, h1, h2, w2_rows, w2_cols).bytes()) return false;
  if (policy_w2_resident(h1, h2, w2_rows, w2_cols)) return true;
  const uintptr_t w2 = (uintptr_t)p + sizeof(float) * policy_w2_offset(nx, h1);
  return (w2_rows == 8 || w2_rows == 16 || w2_rows == 32) && h1 % w2_rows == 0 && w2 % 16 == 0;
}

struct PolicySmem {
  float *w2, *w1, *b1, *b2, *w3, *b3, *nmean, *ninv, *obs, *h1, *h2, *mu;
};

__device__ __forceinline__ PolicySmem policy_smem(int nx, int nu, int h1, int h2, int w2_rows,
                                                  int w2_cols) {
  extern __shared__ float4 scg_policy_smem[];
  float* base = reinterpret_cast<float*>(scg_policy_smem);
  const PolicyLayout l(nx, nu, h1, h2, w2_rows, w2_cols);
  return PolicySmem{base + l.w2, base + l.w1, base + l.b1, base + l.b2,
                    base + l.w3, base + l.b3, base + l.nmean, base + l.ninv,
                    base + l.obs, base + l.h1, base + l.h2, base + l.mu};
}

// The register tile of a dense layer with n outputs a row: 0 for 4 envs x 8
// units, 1 for 4 x 4, 2 for 2 x 4, the largest whose count still gives every
// thread one; and how many rounds of the block's threads cover the tiles.
__device__ __forceinline__ int dense_shape(int n) {
  const int outputs = kPolicyEnvs * n;
  return outputs >= 32 * kPolicyThreads ? 0 : outputs >= 16 * kPolicyThreads ? 1 : 2;
}

__device__ __forceinline__ int dense_rounds(int n) {
  const int shape = dense_shape(n);
  const int tiles = shape == 0 ? n : shape == 1 ? 2 * n : 4 * n;  // (E / RE) (n / RU)
  return (tiles + kPolicyThreads - 1) / kPolicyThreads;
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src));
}

// W2 streamed through two shared-memory tiles of `rows` rows by up to `cols`
// columns, stored compact (a tile of w columns has row stride w). The block
// consumes an endless sequence of tiles; the q-th sits in buffer q & 1, and
// the copy of tile q + 2 starts as soon as tile q has been used. With H2
// whole (cols == n) the sequence is W2's row tiles 0, 1, ..., 0, 1, ...;
// CHUNKED, it is, for each chunk of `cols` units of H2 (the last one
// narrower) and each of dense_rounds(w) rounds, the chunk's row tiles, and
// every thread keeps the same cursor of the next copy.
template <bool CHUNKED>
struct W2Ring {
  float* buf;
  const float* src;
  int rows, cols, n, row_tiles;
  int next;            // tiles consumed
  int c0, round, kt;   // CHUNKED: the next copy's chunk (first unit), round, row tile

  __device__ void issue(int q) {
    float* dst = buf + (q & 1) * rows * cols;
    if constexpr (!CHUNKED) {  // one contiguous range
      const float* from = src + (size_t)(q % row_tiles) * rows * n;
      for (int i = threadIdx.x; i < rows * n / 4; i += kPolicyThreads) {
        cp_async16(dst + 4 * i, from + 4 * i);
      }
    } else {
      const int w = min(cols, n - c0), w4 = w / 4;
      const float* from = src + (size_t)kt * rows * n + c0;
      for (int i = threadIdx.x; i < rows * w4; i += kPolicyThreads) {
        const int r = i / w4, j = i - r * w4;
        cp_async16(dst + r * w + 4 * j, from + (size_t)r * n + 4 * j);
      }
      if (++kt == row_tiles) {
        kt = 0;
        if (++round == dense_rounds(w)) {
          round = 0;
          c0 = c0 + cols < n ? c0 + cols : 0;
        }
      }
    }
    asm volatile("cp.async.commit_group;\n" ::);
  }
  __device__ void start() {
    next = c0 = round = kt = 0;
    issue(0);
    issue(1);
  }
  // The next tile, once every thread's copies of it have landed.
  __device__ const float* acquire() const {
    asm volatile("cp.async.wait_group 1;\n" ::);
    __syncthreads();
    return buf + (next & 1) * rows * cols;
  }
  __device__ void release() {
    __syncthreads();
    issue(next + 2);
    ++next;
  }
  __device__ void drain() const { asm volatile("cp.async.wait_all;\n" ::); }
};

// b2 and W3's first NU columns of H2's units [c0, c0 + w) into shared memory.
template <int NX, int NU>
__device__ void policy_stage_chunk(const PolicyMLP& m, const PolicySmem& s, int c0, int w) {
  const float* b2 = m.p + policy_w2_offset(NX, m.h1) + (size_t)m.h1 * m.h2;
  const float* w3 = b2 + m.h2;
  for (int i = threadIdx.x; i < w; i += kPolicyThreads) s.b2[i] = b2[c0 + i];
  for (int i = threadIdx.x; i < w * NU; i += kPolicyThreads) {
    s.w3[i] = w3[(size_t)(c0 + i / NU) * m.nu_out + i % NU];
  }
}

// Copy the packed actor's resident parts into shared memory (once, at block
// start) and start the W2 ring where W2 streams. b2 and W3 are resident
// unless H2 runs in chunks, which stage their own. The caller syncs.
template <int NX, int NU, bool CHUNKED>
__device__ void policy_stage(const PolicyMLP& m, const PolicySmem& s, int w2_rows, int w2_cols,
                             W2Ring<CHUNKED>& ring) {
  const float* g = m.p;
  const float* w1 = g + 2 * NX;
  const float* b1 = w1 + NX * m.h1;
  const float* w2 = b1 + m.h1;
  const float* b3 = w2 + (size_t)m.h1 * m.h2 + m.h2 + (size_t)m.h2 * m.nu_out;
  const int tid = threadIdx.x;
  for (int i = tid; i < NX; i += kPolicyThreads) {
    s.nmean[i] = g[i];
    s.ninv[i] = g[NX + i];
  }
  for (int i = tid; i < NX * m.h1; i += kPolicyThreads) s.w1[i] = w1[i];
  for (int i = tid; i < m.h1; i += kPolicyThreads) s.b1[i] = b1[i];
  for (int i = tid; i < NU; i += kPolicyThreads) s.b3[i] = b3[i];
  if constexpr (!CHUNKED) policy_stage_chunk<NX, NU>(m, s, 0, m.h2);
  ring = W2Ring<CHUNKED>{s.w2, w2, w2_rows, w2_cols, m.h2, m.h1 / w2_rows, 0, 0, 0, 0};
  if (policy_w2_resident(m.h1, m.h2, w2_rows, w2_cols)) {
    for (int i = tid; i < m.h1 * m.h2; i += kPolicyThreads) s.w2[i] = w2[i];
  } else {
    ring.start();
  }
}

// The obs of env e (a warp-0 thread) into shared memory as [k][e].
template <int NX>
__device__ __forceinline__ void policy_write_obs(const PolicyMLP& m, const PolicySmem& s,
                                                 const float (&st)[NX], int e) {
#pragma unroll
  for (int k = 0; k < NX; ++k) {
    s.obs[k * kPolicyEnvs + e] =
        fminf(fmaxf((st[k] - s.nmean[k]) * s.ninv[k], -m.clip_obs), m.clip_obs);
  }
}

template <int R>
__device__ __forceinline__ void load_row(const float* p, float (&v)[R]) {
  if constexpr (R == 4) {
    const float4 q = *reinterpret_cast<const float4*>(p);
    v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
  } else {
    const float2 q = *reinterpret_cast<const float2*>(p);
    v[0] = q.x; v[1] = q.y;
  }
}

template <int R>
__device__ __forceinline__ void store_row(float* p, const float (&v)[R]) {
  if constexpr (R == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  } else {
    *reinterpret_cast<float2*>(p) = make_float2(v[0], v[1]);
  }
}

// A thread's tile: envs [e0, e0 + RE) and units u0 + [0, 4), plus, for RU = 8,
// u0 + n / 2 + [0, 4): neighbouring threads take neighbouring env groups, so
// the activation loads and the stores of a warp are contiguous and its weight
// loads broadcast.
__device__ __forceinline__ int tile_unit(int u0, int j, int n) {
  return j < 4 ? u0 + j : u0 + n / 2 + j - 4;
}

// acc += in^T w over `rows` inputs in ascending order: in is [rows][E], w is
// [rows][n], both from the first input to sum.
template <int RE, int RU>
__device__ __forceinline__ void dense_accumulate(float (&acc)[RE][RU], const float* in,
                                                 const float* w, int n, int rows, int e0,
                                                 int u0) {
#pragma unroll 4
  for (int k = 0; k < rows; ++k) {
    float x[RE], wv[RU];
    load_row<RE>(in + k * kPolicyEnvs + e0, x);
    const float* wr = w + k * n + u0;
    const float4 a = *reinterpret_cast<const float4*>(wr);
    wv[0] = a.x; wv[1] = a.y; wv[2] = a.z; wv[3] = a.w;
    if constexpr (RU == 8) {
      const float4 b = *reinterpret_cast<const float4*>(wr + n / 2);
      wv[4] = b.x; wv[5] = b.y; wv[6] = b.z; wv[7] = b.w;
    }
#pragma unroll
    for (int i = 0; i < RE; ++i) {
#pragma unroll
      for (int j = 0; j < RU; ++j) acc[i][j] = acc[i][j] + x[i] * wv[j];
    }
  }
}

template <int RE, int RU>
__device__ __forceinline__ void dense_store(const float (&acc)[RE][RU], const float* bias,
                                            float* out, int n, int e0, int u0, bool relu) {
#pragma unroll
  for (int j = 0; j < RU; ++j) {
    const int u = tile_unit(u0, j, n);
    float v[RE];
#pragma unroll
    for (int i = 0; i < RE; ++i) v[i] = policy_act(acc[i][j] + bias[u], relu);
    store_row<RE>(out + u * kPolicyEnvs + e0, v);
  }
}

// out = act(in^T w + bias) for an [rows][E] input and [rows][n] weights in
// shared memory, or (ring != nullptr) weights streamed tile by tile. Every
// thread of the block calls it.
template <int RE, int RU, class Ring>
__device__ void dense_layer(const float* in, const float* w, Ring* ring, const float* bias,
                            float* out, int rows, int n, bool relu) {
  constexpr int kGroups = kPolicyEnvs / RE;
  const int n_tiles = kGroups * (n / RU);
  for (int t0 = 0; t0 < n_tiles; t0 += kPolicyThreads) {  // the same rounds in every thread
    const int t = t0 + threadIdx.x;
    const bool active = t < n_tiles;
    const int e0 = (t % kGroups) * RE;
    const int u0 = (t / kGroups) * 4;
    float acc[RE][RU];
#pragma unroll
    for (int i = 0; i < RE; ++i) {
#pragma unroll
      for (int j = 0; j < RU; ++j) acc[i][j] = 0.0f;
    }
    if (ring == nullptr) {
      if (active) dense_accumulate<RE, RU>(acc, in, w, n, rows, e0, u0);
    } else {
      for (int kt = 0; kt < ring->row_tiles; ++kt) {
        const float* tile = ring->acquire();
        if (active) {
          dense_accumulate<RE, RU>(acc, in + kt * ring->rows * kPolicyEnvs, tile, n,
                                   ring->rows, e0, u0);
        }
        ring->release();
      }
    }
    if (active) dense_store<RE, RU>(acc, bias, out, n, e0, u0, relu);
  }
}

template <class Ring>
__device__ __forceinline__ void dense(const float* in, const float* w, Ring* ring,
                                      const float* bias, float* out, int rows, int n,
                                      bool relu) {
  const int shape = dense_shape(n);
  if (shape == 0) {
    dense_layer<4, 8>(in, w, ring, bias, out, rows, n, relu);
  } else if (shape == 1) {
    dense_layer<4, 4>(in, w, ring, bias, out, rows, n, relu);
  } else {
    dense_layer<2, 4>(in, w, ring, bias, out, rows, n, relu);
  }
}

// acc + the sum over the w units j of the h2 in shared memory of
// h2[j][e] W3[j][d], in ascending j.
template <int NU>
__device__ __forceinline__ float out_accumulate(const PolicySmem& s, int e, int d, int w,
                                                float acc) {
#pragma unroll 8
  for (int j = 0; j < w; ++j) acc = acc + s.h2[j * kPolicyEnvs + e] * s.w3[j * NU + d];
  return acc;
}

// The actor on the obs that warp 0 has written: mu (the first NU outputs) in
// shared memory as [d][e] when it returns. CHUNKED, layers 2 and 3 run over
// H2 in chunks of w2_cols units. Every thread of the block calls it.
template <int NX, int NU, bool CHUNKED>
__device__ void policy_actor(const PolicyMLP& m, const PolicySmem& s, bool w2_resident,
                             int w2_cols, W2Ring<CHUNKED>& ring) {
  __syncthreads();  // every env's obs written
  dense(s.obs, s.w1, static_cast<W2Ring<CHUNKED>*>(nullptr), s.b1, s.h1, NX, m.h1, m.relu);
  __syncthreads();
  const int tid = threadIdx.x;
  const int e = tid % kPolicyEnvs, d = tid / kPolicyEnvs;
  float acc = 0.0f;
  if constexpr (!CHUNKED) {
    dense(s.h1, s.w2, w2_resident ? nullptr : &ring, s.b2, s.h2, m.h1, m.h2, m.relu);
    __syncthreads();
    if (tid < NU * kPolicyEnvs) acc = out_accumulate<NU>(s, e, d, m.h2, acc);
  } else {
    for (int c0 = 0; c0 < m.h2; c0 += w2_cols) {
      const int w = min(w2_cols, m.h2 - c0);
      // Read by layer 2's stores and by layer 3, both past the ring's barriers.
      policy_stage_chunk<NX, NU>(m, s, c0, w);
      dense(s.h1, s.w2, &ring, s.b2, s.h2, m.h1, w, m.relu);
      __syncthreads();
      if (tid < NU * kPolicyEnvs) acc = out_accumulate<NU>(s, e, d, w, acc);
      __syncthreads();  // this chunk's h2, b2 and W3 read
    }
  }
  if (tid < NU * kPolicyEnvs) s.mu[d * kPolicyEnvs + e] = acc + s.b3[d];
  __syncthreads();
}

}  // namespace scg
