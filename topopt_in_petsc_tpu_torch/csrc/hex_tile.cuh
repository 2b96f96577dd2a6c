// Shared building blocks of the hex-operator kernels K1 (hex_operator.cu),
// K3 and K4 (nodal_hex.cu), of K2 (quadform.cu) and of K1-bf16's column
// body (hex_operator.cu): the shared-memory tile kernel body
// `tile_operator` (a block stages x-planes of its element tile and forms
// the element products u_e @ KE, the plain versions' `ue @ KE`, from
// there), the element products, on the f32 FMA pipes, and the grid
// helpers.
//
// One body serves every operator K(E) u of the package: DOF 3
// (elasticity, KE (24, 24)) or 1 (the Helmholtz filter, KF (8, 8)), on
// the component-major node layout (DOF, nx, ny, nz) of K1 or the
// node-major layout (nx, ny, nz, DOF) of K3 and K4, with or without K1's
// x = 0 mask; E is (nx-1, ny-1, nz-1).  All contiguous, z fastest.
//
// Tile.  A block owns a y-z tile of the grid and walks along x.  One
// element plane of the tile is EY x EZ elements over (EY+1) x (EZ+1)
// nodes.  Node planes ([component][y][z] in shared memory whatever the
// layout in device memory, the component stride padded to 8 mod 32 words
// so that a node's three components fall in three bank octets) and
// element planes arrive by cp.async into a ring of kStages + 2 slots: the
// two node planes of the current element plane, and kStages planes in
// flight, so a step's copies meet DRAM's latency kStages steps of compute
// later.  Each thread copies consecutive words of device memory (a y-row
// of the node-major tile is one run of DOF (EZ+1) floats) into their
// shared slots.  Nodes outside the grid are zero-filled by the copy
// (src-size 0), so the ragged edge needs no pads and no branches in the
// products.  Each thread copies the same slots at every step: their
// offsets are computed once, the y-z tile being fixed while the block
// walks x.
//
// The element products, one element per thread; the element matrix is a
// __grid_constant__ kernel parameter whose entries are constant-bank
// operands:
// - generic: (8 DOF)^2 FMAs against KE;
// - reflection (when KE has the brick's symmetry, which the host checks
//   at every launch): the element's three mid-plane reflections map
//   corner a to a XOR g (corner bits ox | oy << 1 | oz << 2) and, for
//   DOF 3, flip the reflected displacement components (D_g; a scalar
//   field has no components to flip, D = 1), and KE commutes with them,
//   so with v_a = D_a u_a, D_a f_a = sum_b P(a XOR b) v_b is a
//   convolution over Z2^3 with DOF x DOF blocks P(c) = M(0, c) D_c.  An
//   8-point Walsh-Hadamard transform diagonalises it: f = D WHT(Q_k
//   WHT(D u)_k) with Q_k = WHT(P)_k / 8.  DOF 3: 72 adds + 72 FMAs + 72
//   adds in place of 576 FMAs, and u_e . f_e = sum_k V_k . Q_k V_k
//   (Parseval); DOF 1: 24 adds + 8 multiplies + 24 adds in place of 64
//   FMAs, and the constant mode (the element's mass, ~100x smaller than
//   its Laplacian modes on a fine grid) stays in Q_0 instead of being
//   rebuilt from larger terms.  Exact in real arithmetic for any
//   axis-aligned brick; f32-rounded like the generic product.
//
// Storage: u, E and out are f32 (K1-bf16 has a body of its own,
// hex_operator.cu).

#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <string.h>

namespace hex_tile {

// The element matrix as a kernel parameter: KE row-major (8 DOF, 8 DOF)
// and, when KE has the reflection symmetry, its 8 blocks Q_k, row-major
// (DOF, DOF).
template <int DOF>
struct ElemParams {
  float v[64 * DOF * DOF];
  float q[8 * DOF * DOF];
};
using KEParams = ElemParams<3>;

// reference hex corner order (grid.CORNER_OFFSETS)
__host__ __device__ constexpr int ox(int a) { return ((a + 1) >> 1) & 1; }
__host__ __device__ constexpr int oy(int a) { return (a >> 1) & 1; }
__host__ __device__ constexpr int oz(int a) { return a >> 2; }

// corner a as bits ox | oy << 1 | oz << 2, the reflection group's index
__host__ __device__ constexpr int bits(int a) {
  return ox(a) | oy(a) << 1 | oz(a) << 2;
}

// whether reflection c flips component i of a DOF-component field
template <int DOF>
__host__ __device__ constexpr bool flips(int c, int i) {
  return DOF == 3 && ((c >> i) & 1);
}

// Fills p from the row-major (8 DOF, 8 DOF) f32 matrix ke_host and
// returns whether KE has the reflection symmetry (to 1e-6 of max|KE|: KE
// rounded to f32 keeps it to ~1e-7), in which case p->q holds its blocks
// Q_k (summed in f64).  With f = ue @ KE,
// f_a = sum_b M(a, b) u_b, M(a, b)[i][j] = KE[DOF b + j][DOF a + i].
// The last few matrices are cached: a solve alternates among its levels'.
template <int DOF>
inline bool element_params(const float* ke_host, ElemParams<DOF>* p) {
  constexpr int W = 8 * DOF;
  struct Entry {
    ElemParams<DOF> params;
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
    return p->v[(DOF * b + j) * W + DOF * a + i];
  };
  auto flip = [](int c, int i) { return flips<DOF>(c, i) ? -1.0 : 1.0; };
  int corner[8];
  for (int a = 0; a < 8; ++a) corner[bits(a)] = a;
  double scale = 0.0, err = 0.0;
  for (int r = 0; r < W * W; ++r) scale = fmax(scale, fabs(p->v[r]));
  // M(a, b) = D_a M(0, a XOR b) D_a
  for (int a = 0; a < 8; ++a)
    for (int b = 0; b < 8; ++b)
      for (int i = 0; i < DOF; ++i)
        for (int j = 0; j < DOF; ++j) {
          const int c = corner[bits(a) ^ bits(b)];
          const double want =
              flip(bits(a), i) * M(0, c, i, j) * flip(bits(a), j);
          err = fmax(err, fabs(M(a, b, i, j) - want));
        }
  const bool sym = err <= 1e-6 * scale;
  // Q_k = (1/8) sum_c (-1)^popcount(k & c) P(c), P(c) = M(0, c) D_c
  for (int k = 0; k < 8; ++k)
    for (int i = 0; i < DOF; ++i)
      for (int j = 0; j < DOF; ++j) {
        double acc = 0.0;
        for (int c = 0; c < 8; ++c)
          acc += (__builtin_popcount(k & c) & 1 ? -1.0 : 1.0) *
                 M(0, corner[c], i, j) * flip(c, j);
        p->q[DOF * DOF * k + DOF * i + j] = static_cast<float>(acc / 8.0);
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

// One x-plane of a block's element tile, for a DOF-component field.
template <int EY_, int EZ_, int DOF_>
struct Plane {
  static constexpr int EY = EY_, EZ = EZ_, DOF = DOF_;
  static constexpr int NE = EY * EZ;  // elements
  static constexpr int PY = EY + 1, PZ = EZ + 1;
  static constexpr int NP = PY * PZ;                   // nodes
  static constexpr int CS = pad_to(NP, 32, 8);         // component stride
  static constexpr int PB = pad_to(DOF * CS, 32, 24);  // node-plane slot
  static constexpr int ES = pad_to(NE, 16, 0);         // element-plane slot

  // offset of element r's corner-0 node in a node-plane slot
  __device__ static int row_offset(int r) {
    const int j = r / EZ;
    return j * PZ + (r - j * EZ);
  }
  // offset of dof c = DOF a + i of an element from its corner-0 node
  __host__ __device__ static constexpr int col_offset(int c) {
    return (c % DOF) * CS + oy(c / DOF) * PZ + oz(c / DOF);
  }
};

// -- the element products -------------------------------------------------- //

// ue: the 8 DOF dofs of the element at offset o, with the element's node
// planes x in slot b0 and x+1 in slot b1
template <class P>
__device__ __forceinline__ void gather_element(const float* su, int b0,
                                               int b1, int o,
                                               float (&ue)[8 * P::DOF]) {
#pragma unroll
  for (int c = 0; c < 8 * P::DOF; ++c)
    ue[c] = su[(ox(c / P::DOF) ? b1 : b0) * P::PB + P::col_offset(c) + o];
}

// f = ue @ KE; with the loops unrolled every KE entry is a constant-bank
// operand of the kernel's __grid_constant__ parameter.
template <int DOF>
__device__ __forceinline__ void element_product(const float (&ue)[8 * DOF],
                                                const ElemParams<DOF>& ke,
                                                float (&f)[8 * DOF]) {
  constexpr int W = 8 * DOF;
#pragma unroll
  for (int n = 0; n < W; ++n) f[n] = 0.f;
#pragma unroll
  for (int k = 0; k < W; ++k)
#pragma unroll
    for (int n = 0; n < W; ++n) f[n] = fmaf(ue[k], ke.v[W * k + n], f[n]);
}

// the unnormalised 8-point Walsh-Hadamard transform over the corner bits,
// for each of the DOF components
template <int DOF>
__device__ __forceinline__ void wht8(float (&x)[8][DOF]) {
#pragma unroll
  for (int h = 1; h < 8; h <<= 1)
#pragma unroll
    for (int c = 0; c < 8; ++c)
      if (!(c & h))
#pragma unroll
        for (int i = 0; i < DOF; ++i) {
          const float a = x[c][i], b = x[c | h][i];
          x[c][i] = a + b;
          x[c | h][i] = a - b;
        }
}

// V = WHT(D u_e), indexed by corner bits
template <int DOF>
__device__ __forceinline__ void reflect_forward(const float (&ue)[8 * DOF],
                                                float (&x)[8][DOF]) {
#pragma unroll
  for (int a = 0; a < 8; ++a)
#pragma unroll
    for (int i = 0; i < DOF; ++i)
      x[bits(a)][i] =
          flips<DOF>(bits(a), i) ? -ue[DOF * a + i] : ue[DOF * a + i];
  wht8<DOF>(x);
}

// (Q_k V_k)_i
template <int DOF>
__device__ __forceinline__ float block_row(const ElemParams<DOF>& ke,
                                           const float (&x)[8][DOF], int k,
                                           int i) {
  const float* q = ke.q + DOF * DOF * k + DOF * i;
  float acc = q[0] * x[k][0];
#pragma unroll
  for (int j = 1; j < DOF; ++j) acc = fmaf(q[j], x[k][j], acc);
  return acc;
}

// f = ue @ KE by the reflection blocks (KE with the symmetry only)
template <int DOF>
__device__ __forceinline__ void element_product_sym(
    const float (&ue)[8 * DOF], const ElemParams<DOF>& ke,
    float (&f)[8 * DOF]) {
  float x[8][DOF], y[8][DOF];
  reflect_forward<DOF>(ue, x);
#pragma unroll
  for (int k = 0; k < 8; ++k)
#pragma unroll
    for (int i = 0; i < DOF; ++i) y[k][i] = block_row<DOF>(ke, x, k, i);
  wht8<DOF>(y);
#pragma unroll
  for (int a = 0; a < 8; ++a)
#pragma unroll
    for (int i = 0; i < DOF; ++i)
      f[DOF * a + i] =
          flips<DOF>(bits(a), i) ? -y[bits(a)][i] : y[bits(a)][i];
}

// ue . (ue @ KE) = sum_k V_k . Q_k V_k (KE with the symmetry only)
__device__ __forceinline__ float element_quadform_sym(const float (&ue)[24],
                                                      const KEParams& ke) {
  float x[8][3];
  reflect_forward<3>(ue, x);
  float acc = 0.f;
#pragma unroll
  for (int k = 0; k < 8; ++k)
#pragma unroll
    for (int i = 0; i < 3; ++i)
      acc = fmaf(x[k][i], block_row<3>(ke, x, k, i), acc);
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

// -- the tile kernel body -------------------------------------------------- //

// A block's tile: TY x TZ owned nodes in y-z, NT threads, a DOF-component
// field.  Shared memory in the order laid out.
template <int TY, int TZ, int NT, int DOF>
struct Tile {
  static_assert(TY * TZ <= NT, "one owned node per thread");
  using P = Plane<TY + 1, TZ + 1, DOF>;
  static constexpr int FS = pad_to(P::ES, 16, 4);  // element-force stride
  static constexpr int kNodes = kRing * P::PB;     // node-plane ring
  static constexpr int kElems = kRing * P::ES;     // element-plane ring
  static constexpr int kF = 8 * DOF * FS;  // E-scaled forces [dof][element]
  static constexpr int kBytes = 4 * (kNodes + kElems + kF);
};

// out = K(E) u for the block's tile and x chunk [blockIdx.z xc, + xc).
// The node fields u and out are node-major (nx, ny, nz, DOF) if
// kNodeMajor, else component-major (DOF, nx, ny, nz); mask_x0 zeroes the
// x == 0 node plane.  kSym: the element product by the reflection blocks,
// else (8 DOF)^2 FMAs.  Called from a __global__ kernel of NT threads with
// Tile<TY, TZ, NT, DOF>::kBytes of dynamic shared memory.
//
// For each element plane the block forms f_e = E_e * (u_e @ KE) for the
// (TY+1) x (TZ+1) elements that touch the tile, one element per thread,
// into shared memory; then each node sums its corners in a fixed order:
// the previous element plane's corners 1, 2, 5, 6 (kept in registers from
// the last step), then this plane's 0, 3, 4, 7.  No atomics: two launches
// give bitwise-equal output.
template <int TY, int TZ, int NT, int DOF, bool kNodeMajor, bool kSym>
__device__ __forceinline__ void tile_operator(
    const float* __restrict__ u, const float* __restrict__ E,
    float* __restrict__ out, const ElemParams<DOF>& ke, int nx, int ny,
    int nz, int xc, int mask_x0) {
  using TL = Tile<TY, TZ, NT, DOF>;
  using P = typename TL::P;
  constexpr int FS = TL::FS;
  // staged words of a node plane: the padded slots (component-major, the
  // padding zero-filled) or the nodes' words in device order (node-major)
  constexpr int NS = kNodeMajor ? P::NP * DOF : P::PB;
  constexpr int NQ = (NS + NT - 1) / NT;      // staged node words per thread
  constexpr int NEQ = (P::NE + NT - 1) / NT;  // staged elements per thread
  extern __shared__ float4 smem[];
  float* su = reinterpret_cast<float*>(smem);
  float* sE = su + TL::kNodes;
  float* sf = sE + TL::kElems;

  const int tid = threadIdx.x;
  const int z0 = blockIdx.x * TZ, y0 = blockIdx.y * TY;
  const int xa = blockIdx.z * xc, xb = min(xa + xc, nx);
  const int nnode = nx * ny * nz, plane = ny * nz;
  // words of a node plane in device memory
  const int uplane = kNodeMajor ? DOF * plane : plane;
  const int eplane = (ny - 1) * (nz - 1);
  const int e_lo = max(xa - 1, 0), e_hi = min(xb - 1, nx - 2);

  // this thread's staged words q = tid + NT*m: component i of node
  // (y0-1+j, z0-1+k), at shared offset sdst in a node-plane slot and goff
  // in a node plane of u (-1 outside the grid or in the padding); and
  // element-plane slot tid + NT*m at eoff in a plane of E
  int goff[NQ], sdst[NQ], eoff[NEQ];
#pragma unroll
  for (int m = 0; m < NQ; ++m) {
    const int q = tid + m * NT;
    int i, r;
    if constexpr (kNodeMajor) {
      r = q / DOF;
      i = q - r * DOF;
      sdst[m] = i * P::CS + r;
    } else {
      i = q / P::CS;
      r = q - i * P::CS;
      sdst[m] = q;
    }
    const int j = r / P::PZ, k = r - j * P::PZ;
    const int y = y0 - 1 + j, z = z0 - 1 + k;
    const bool in = q < NS && i < DOF && r < P::NP && y >= 0 && y < ny &&
                    z >= 0 && z < nz;
    const int node = y * nz + z;
    goff[m] = !in ? -1 : kNodeMajor ? node * DOF + i : i * nnode + node;
  }
#pragma unroll
  for (int m = 0; m < NEQ; ++m) {
    const int r = tid + m * NT;
    const int j = r / P::EZ, k = r - j * P::EZ;
    const int y = y0 - 1 + j, z = z0 - 1 + k;
    const bool in = r < P::NE && y >= 0 && y < ny - 1 && z >= 0 && z < nz - 1;
    eoff[m] = in ? y * (nz - 1) + z : -1;
  }

  // node plane x and element plane x into ring slot x % kRing, each only
  // if the block uses it (node planes up to e_hi + 1, element planes up
  // to e_hi), as one copy group per call
  auto fetch = [&](int x) {
    if (x <= e_hi + 1) {
      float* dst = su + (x % kRing) * P::PB;
      const float* src = u + x * uplane;
#pragma unroll
      for (int m = 0; m < NQ; ++m)
        if (tid + m * NT < NS)
          cp_async4(dst + sdst[m], src + max(goff[m], 0), goff[m] >= 0);
    }
    if (x <= e_hi) {
      float* dst = sE + (x % kRing) * P::ES;
      const float* src = E + x * eplane;
#pragma unroll
      for (int m = 0; m < NEQ; ++m)
        if (tid + m * NT < P::NE)
          cp_async4(dst + tid + m * NT, src + max(eoff[m], 0),
                    eoff[m] >= 0);
    }
    cp_async_commit();
  };
  // planes e_lo .. e_lo + kStages in flight: the group of plane p is the
  // (p - e_lo)-th
  for (int p = 0; p <= kStages; ++p) fetch(e_lo + p);

  // the owned node (y0+jj, z0+kk): corner a's element is row
  // base - oy(a) * EZ - oz(a) of an element plane
  const int idx = min(tid, TY * TZ - 1);
  const int jj = idx / TZ, kk = idx - jj * TZ;
  const bool owner = tid < TY * TZ && y0 + jj < ny && z0 + kk < nz;
  const int base = (jj + 1) * P::EZ + kk + 1;
  const int onode = (y0 + jj) * nz + z0 + kk;  // in a node plane of out
  // word of component i of the owned node in node plane x of out
  auto oword = [&](int x, int i) {
    return kNodeMajor ? (x * plane + onode) * DOF + i
                      : i * nnode + x * plane + onode;
  };
  float nxt[DOF];
#pragma unroll
  for (int i = 0; i < DOF; ++i) nxt[i] = 0.f;

  for (int ex = e_lo; ex <= e_hi; ++ex) {
    // node planes ex and ex+1 (and element plane ex) have landed: the
    // kStages - 1 newest groups may still be in flight
    cp_async_wait<kStages - 1>();
    __syncthreads();
    // into the slot of plane ex-1, which no product reads any more
    fetch(ex + kStages + 1);
    const int b0 = ex % kRing, b1 = (ex + 1) % kRing;
    const float* sEp = sE + b0 * P::ES;

    // element forces of plane ex
    for (int r = tid; r < P::NE; r += NT) {
      float ue[8 * DOF], f[8 * DOF];
      gather_element<P>(su, b0, b1, P::row_offset(r), ue);
      if constexpr (kSym) element_product_sym<DOF>(ue, ke, f);
      else element_product<DOF>(ue, ke, f);
      const float e = sEp[r];
#pragma unroll
      for (int c = 0; c < 8 * DOF; ++c) sf[c * FS + r] = e * f[c];
    }
    __syncthreads();

    // node sums: node plane ex completes, node plane ex+1 starts
    float cur[DOF], nx1[DOF];
#pragma unroll
    for (int i = 0; i < DOF; ++i) {
      cur[i] = nxt[i];
      nx1[i] = 0.f;
    }
#pragma unroll
    for (int a = 0; a < 8; ++a)
#pragma unroll
      for (int i = 0; i < DOF; ++i) {
        const float v = sf[(DOF * a + i) * FS + base - oy(a) * P::EZ - oz(a)];
        if (ox(a)) nx1[i] += v;
        else cur[i] += v;
      }
#pragma unroll
    for (int i = 0; i < DOF; ++i) nxt[i] = nx1[i];
    if (owner && ex >= xa) {
      const bool zero = mask_x0 && ex == 0;
#pragma unroll
      for (int i = 0; i < DOF; ++i)
        out[oword(ex, i)] = zero ? 0.f : cur[i];
    }
  }
  // the last node plane of the grid has no element plane after it
  if (owner && e_hi + 1 < xb)
#pragma unroll
    for (int i = 0; i < DOF; ++i)
      out[oword(e_hi + 1, i)] = nxt[i];
}

// The launch grid of a tile kernel (TY x TZ nodes, NT threads, `smem`
// bytes) on an nx x ny x nz grid: (z tiles, y tiles, x chunks), with the
// chunk length in *xc.  A chunk of node planes also computes the element
// plane before it.
template <auto kernel, int TY, int TZ, int NT>
dim3 tile_grid(int nx, int ny, int nz, int smem, int* xc) {
  const int resident = resident_blocks<kernel>(NT, smem);
  const int gy = (ny + TY - 1) / TY, gz = (nz + TZ - 1) / TZ;
  int chunks;
  *xc = x_chunk(nx, 1, gy * gz, resident, &chunks);
  return dim3(gz, gy, chunks);
}

}  // namespace hex_tile
