// Shared building blocks of K1 (hex_operator.cu) and K2 (quadform.cu):
// K1's shared-memory tile (a block stages x-planes of its element tile
// and forms the element products u_e @ KE, the plain versions'
// `ue @ KE`, from there) and the element products of both kernels, on
// the f32 FMA pipes.
//
// Tile.  A block owns a y-z tile of the grid and walks along x.  One
// element plane of the tile is EY x EZ elements over (EY+1) x (EZ+1)
// nodes.  Node planes ([component][y][z], the component stride padded to
// 8 mod 32 words so that a node's three components fall in three bank
// octets) and element planes arrive by cp.async into a ring of
// kStages + 2 slots: the two node planes of the current element plane,
// and kStages planes in flight, so a step's copies meet DRAM's latency
// kStages steps of compute later.  Nodes outside the grid are
// zero-filled by the copy (src-size 0), so the ragged edge needs no pads
// and no branches in the products.  Each thread copies the same slots at
// every step: their offsets are computed once, the y-z tile being fixed
// while the block walks x.
//
// The FMA products, one element per thread; the element matrix is a
// __grid_constant__ kernel parameter whose entries are constant-bank
// operands:
// - generic: 576 FMAs against KE;
// - reflection (when KE has the brick's symmetry, which the host checks
//   at every launch): the element's three mid-plane reflections map
//   corner a to a XOR g (corner bits ox | oy << 1 | oz << 2) and flip the
//   reflected displacement components (D_g), and KE commutes with them,
//   so with v_a = D_a u_a, D_a f_a = sum_b P(a XOR b) v_b is a
//   convolution over Z2^3 with 3 x 3 blocks P(c) = M(0, c) D_c.  An
//   8-point Walsh-Hadamard transform diagonalises it: f = D WHT(Q_k
//   WHT(D u)_k) with Q_k = WHT(P)_k / 8, 72 adds + 72 FMAs + 72 adds in
//   place of 576 FMAs; and u_e . f_e = sum_k V_k . Q_k V_k (Parseval).
//   Exact in real arithmetic for any axis-aligned brick (hx, hy, hz, nu);
//   f32-rounded like the generic product.

#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <string.h>

namespace hex_tile {

// The element matrix as a kernel parameter: KE row-major (24, 24) and, when
// KE has the reflection symmetry, its 8 blocks Q_k, row-major (3, 3).
struct KEParams {
  float v[576];
  float q[72];
};

// reference hex corner order (grid.CORNER_OFFSETS)
__host__ __device__ constexpr int ox(int a) { return ((a + 1) >> 1) & 1; }
__host__ __device__ constexpr int oy(int a) { return (a >> 1) & 1; }
__host__ __device__ constexpr int oz(int a) { return a >> 2; }

// corner a as bits ox | oy << 1 | oz << 2, the reflection group's index
__host__ __device__ constexpr int bits(int a) {
  return ox(a) | oy(a) << 1 | oz(a) << 2;
}

// Fills p from the row-major (24, 24) f32 matrix ke_host and returns
// whether KE has the reflection symmetry (to 1e-6 of max|KE|: KE rounded
// to f32 keeps it to ~1e-7), in which case p->q holds its blocks Q_k.
// With f = ue @ KE, f_a = sum_b M(a, b) u_b, M(a, b)[i][j] = KE[3b+j][3a+i].
// The last few matrices are cached: a solve alternates among its levels'.
inline bool element_params(const float* ke_host, KEParams* p) {
  struct Entry {
    KEParams params;
    bool sym;
  };
  constexpr int kCache = 8;
  thread_local Entry cache[kCache];
  thread_local int filled = 0, next = 0;
  for (int e = 0; e < filled; ++e)
    if (memcmp(cache[e].params.v, ke_host, sizeof(p->v)) == 0) {
      *p = cache[e].params;
      return cache[e].sym;
    }
  memcpy(p->v, ke_host, sizeof(p->v));
  auto M = [&](int a, int b, int i, int j) -> double {
    return p->v[(3 * b + j) * 24 + 3 * a + i];
  };
  auto flip = [](int c, int i) { return (c >> i) & 1 ? -1.0 : 1.0; };
  int corner[8];
  for (int a = 0; a < 8; ++a) corner[bits(a)] = a;
  double scale = 0.0, err = 0.0;
  for (int r = 0; r < 576; ++r) scale = fmax(scale, fabs(p->v[r]));
  // M(a, b) = D_a M(0, a XOR b) D_a
  for (int a = 0; a < 8; ++a)
    for (int b = 0; b < 8; ++b)
      for (int i = 0; i < 3; ++i)
        for (int j = 0; j < 3; ++j) {
          const int c = corner[bits(a) ^ bits(b)];
          const double want =
              flip(bits(a), i) * M(0, c, i, j) * flip(bits(a), j);
          err = fmax(err, fabs(M(a, b, i, j) - want));
        }
  const bool sym = err <= 1e-6 * scale;
  // Q_k = (1/8) sum_c (-1)^popcount(k & c) P(c), P(c) = M(0, c) D_c
  for (int k = 0; k < 8; ++k)
    for (int i = 0; i < 3; ++i)
      for (int j = 0; j < 3; ++j) {
        double acc = 0.0;
        for (int c = 0; c < 8; ++c)
          acc += (__builtin_popcount(k & c) & 1 ? -1.0 : 1.0) *
                 M(0, corner[c], i, j) * flip(c, j);
        p->q[9 * k + 3 * i + j] = static_cast<float>(acc / 8.0);
      }
  Entry& e = cache[next];
  e.params = *p;
  e.sym = sym;
  next = (next + 1) % kCache;
  if (filled < kCache) ++filled;
  return sym;
}

// the smallest n >= m with n % mod == rem
__host__ __device__ constexpr int pad_to(int m, int mod, int rem) {
  return m + ((rem - m % mod) % mod + mod) % mod;
}

// Node planes in flight ahead of the step that reads them; the ring holds
// two more, the node planes of the current element plane.
constexpr int kStages = 3;
constexpr int kRing = kStages + 2;

// One x-plane of a block's element tile.
template <int EY_, int EZ_>
struct Plane {
  static constexpr int EY = EY_, EZ = EZ_;
  static constexpr int NE = EY * EZ;  // elements
  static constexpr int PY = EY + 1, PZ = EZ + 1;
  static constexpr int NP = PY * PZ;                 // nodes
  static constexpr int CS = pad_to(NP, 32, 8);       // component stride
  static constexpr int PB = pad_to(3 * CS, 32, 24);  // node-plane slot
  static constexpr int ES = pad_to(NE, 16, 0);       // element-plane slot

  // offset of element r's corner-0 node in a node-plane slot
  __device__ static int row_offset(int r) {
    const int j = r / EZ;
    return j * PZ + (r - j * EZ);
  }
  // offset of dof c = 3a + i of an element from its corner-0 node
  __host__ __device__ static constexpr int col_offset(int c) {
    return (c % 3) * CS + oy(c / 3) * PZ + oz(c / 3);
  }
};

// -- the FMA product ------------------------------------------------------- //

// ue: the 24 dofs of the element at offset o, with the element's node
// planes x in slot b0 and x+1 in slot b1
template <class P>
__device__ __forceinline__ void gather_element(const float* su, int b0,
                                               int b1, int o,
                                               float (&ue)[24]) {
#pragma unroll
  for (int c = 0; c < 24; ++c)
    ue[c] = su[(ox(c / 3) ? b1 : b0) * P::PB + P::col_offset(c) + o];
}

// f = ue @ KE; with the loops unrolled every KE entry is a constant-bank
// operand of the kernel's __grid_constant__ parameter.
__device__ __forceinline__ void element_product(const float (&ue)[24],
                                                const KEParams& ke,
                                                float (&f)[24]) {
#pragma unroll
  for (int n = 0; n < 24; ++n) f[n] = 0.f;
#pragma unroll
  for (int k = 0; k < 24; ++k)
#pragma unroll
    for (int n = 0; n < 24; ++n) f[n] = fmaf(ue[k], ke.v[24 * k + n], f[n]);
}

// the unnormalised 8-point Walsh-Hadamard transform over the corner bits,
// for each of the 3 components
__device__ __forceinline__ void wht8(float (&x)[8][3]) {
#pragma unroll
  for (int h = 1; h < 8; h <<= 1)
#pragma unroll
    for (int c = 0; c < 8; ++c)
      if (!(c & h))
#pragma unroll
        for (int i = 0; i < 3; ++i) {
          const float a = x[c][i], b = x[c | h][i];
          x[c][i] = a + b;
          x[c | h][i] = a - b;
        }
}

// V = WHT(D u_e), indexed by corner bits
__device__ __forceinline__ void reflect_forward(const float (&ue)[24],
                                                float (&x)[8][3]) {
#pragma unroll
  for (int a = 0; a < 8; ++a)
#pragma unroll
    for (int i = 0; i < 3; ++i)
      x[bits(a)][i] = (bits(a) >> i) & 1 ? -ue[3 * a + i] : ue[3 * a + i];
  wht8(x);
}

// (Q_k V_k)_i
__device__ __forceinline__ float block_row(const KEParams& ke,
                                           const float (&x)[8][3], int k,
                                           int i) {
  const float* q = ke.q + 9 * k + 3 * i;
  return fmaf(q[2], x[k][2], fmaf(q[1], x[k][1], q[0] * x[k][0]));
}

// f = ue @ KE by the reflection blocks (KE with the symmetry only)
__device__ __forceinline__ void element_product_sym(const float (&ue)[24],
                                                    const KEParams& ke,
                                                    float (&f)[24]) {
  float x[8][3], y[8][3];
  reflect_forward(ue, x);
#pragma unroll
  for (int k = 0; k < 8; ++k)
#pragma unroll
    for (int i = 0; i < 3; ++i) y[k][i] = block_row(ke, x, k, i);
  wht8(y);
#pragma unroll
  for (int a = 0; a < 8; ++a)
#pragma unroll
    for (int i = 0; i < 3; ++i)
      f[3 * a + i] = (bits(a) >> i) & 1 ? -y[bits(a)][i] : y[bits(a)][i];
}

// ue . (ue @ KE) = sum_k V_k . Q_k V_k (KE with the symmetry only)
__device__ __forceinline__ float element_quadform_sym(const float (&ue)[24],
                                                      const KEParams& ke) {
  float x[8][3];
  reflect_forward(ue, x);
  float acc = 0.f;
#pragma unroll
  for (int k = 0; k < 8; ++k)
#pragma unroll
    for (int i = 0; i < 3; ++i) acc = fmaf(x[k][i], block_row(ke, x, k, i), acc);
  return acc;
}

// ue . (ue @ KE): generic, or by the reflection blocks (KE with the
// symmetry only)
template <bool kSym>
__device__ __forceinline__ float element_quadform(const float (&ue)[24],
                                                  const KEParams& ke) {
  if constexpr (kSym) {
    return element_quadform_sym(ue, ke);
  } else {
    float acc = 0.f;
#pragma unroll
    for (int r = 0; r < 24; ++r) {
      float w = 0.f;
#pragma unroll
      for (int c = 0; c < 24; ++c) w = fmaf(ke.v[r * 24 + c], ue[c], w);
      acc = fmaf(ue[r], w, acc);
    }
    return acc;
  }
}

// -- cp.async staging ------------------------------------------------------ //

// 4-byte copy global -> shared; `valid` false writes a zero (src-size 0,
// src is then not read but must be a mapped address).
__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          bool valid) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;" ::"r"(d),
               "l"(src), "r"(valid ? 4 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}
// wait until at most N of this thread's copy groups are in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}

// -- the walk along x ------------------------------------------------------ //

// Chunk length along x for `planes` planes (each chunk also computing
// `extra` planes of halo) over `tiles` y-z tiles, with `resident` blocks
// on the card at once: the length that minimises waves x steps per block,
// so a small grid spreads over the card while a large one keeps the halo
// planes few.  *chunks gets the number of chunks.
inline int x_chunk(int planes, int extra, int tiles, int resident,
                   int* chunks) {
  long best = -1;
  int len_best = planes;
  for (int len = 1; len <= planes; ++len) {
    const int c = (planes + len - 1) / len;
    if (len > 1 && (planes + len - 2) / (len - 1) == c) continue;
    const long waves = (static_cast<long>(c) * tiles + resident - 1) / resident;
    // a step per plane, the halo's, and one for the block's prologue
    const long cost = waves * (len + extra + 1);
    if (best < 0 || cost < best) {
      best = cost;
      len_best = len;
    }
  }
  *chunks = (planes + len_best - 1) / len_best;
  return len_best;
}

// Blocks of `kernel` (with `smem` dynamic bytes, `threads` threads) that
// the current device holds at once; the dynamic-memory attribute is set
// on the first call for each kernel, before any graph capture.
template <auto kernel>
int resident_blocks(int threads, int smem) {
  static const int blocks = [&] {
    if (smem > 48 * 1024)
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           smem);
    int dev = 0, sms = 0, per_sm = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads,
                                                  smem);
    return per_sm * sms > 0 ? per_sm * sms : 1;
  }();
  return blocks;
}

}  // namespace hex_tile
