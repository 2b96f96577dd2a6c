// K1: matrix-free Hex8 elasticity operator  out = K(E) u  (dof = 3), in
// two builds: f32 storage (hex_operator_f32) and bf16 storage
// (hex_operator_bf16: u, E and out bf16, every operation f32).
//
// Replaces the TPU kernel topopt_in_petsc_tpu/ops/blocked_hex.py::_kernel
// (the resident-layout Pallas kernel built in BlockedHexOperator.__init__,
// with dtype float32 or bfloat16).  Plain PyTorch version:
// ops/hex_operator.py::apply_hex_operator followed by
// BlockedHexOperator.mask0 when mask_x0 is set, on the inputs widened to
// f32 and, for the bf16 build, with the result rounded to bf16.
//
//   out[n] = sum over the (up to) 8 elements e with node n as corner a of
//            E_e * (u_e @ KE)[3a : 3a + 3]
//
// Layout: u and out are (3, nx, ny, nz), E is (nx-1, ny-1, nz-1), all
// contiguous with z fastest.  mask_x0 zeroes the x == 0 node plane (the
// cantilever's clamped wall, LinearElasticity.cc:143-156).
//
// What bounds the f32 build on an H100, at 257^3 nodes: 475 MB of
// compulsory traffic (u and E read, out written), 0.142 ms at 3.35 TB/s.
// The operations are fewer: the reflection product below, the E scaling
// and the node sums come to 5.2 GFLOP, 0.077 ms at the 67 TFLOP/s f32
// peak (576 FMAs per element would be 19.3 GFLOP, 0.289 ms;
// ops/roofline.py).
//
// Design of the f32 build (hex_tile.cuh).  A block owns a 6 x 33 node
// tile in y-z (so the 2^k + 1 extents of the multigrid levels fill whole
// tiles in z) and a chunk of x, whose length x_chunk picks from the grid
// and the card's occupancy.  Walking x, it stages node planes of u
// (one-node halo) and element planes of E in shared memory by cp.async,
// kStages planes ahead of the compute.  For each element plane it forms
// f_e = E_e * (u_e @ KE) for the 7 x 34 elements that touch the tile, one
// element per thread, into shared memory; then each node sums its
// corners in a fixed order:
// the previous element plane's corners 1, 2, 5, 6 (kept in registers from
// the last step), then this plane's 0, 3, 4, 7.  No atomics: two launches
// give bitwise-equal output.  The element product is the brick's
// reflection-block product (a Walsh-Hadamard transform over the 8
// corners, 72 + 72 + 72 operations) when KE has the symmetry, which every
// KE of this package has, else the 576-FMA product.
//
// What this does about the limits of the kernel it replaced (one thread
// per node gathering its 8 elements through L1, 1.22-1.51 ms at 257^3;
// it measured faster than this design's 576-FMA product below 2^20
// nodes, but every KE here has the symmetry, and the reflection product
// beats it at every level, PERF.md):
// 1. loads no longer set the pace: an element's 24 dofs are read from
//    shared memory once per element, where the per-node kernel issued 192
//    loads per node (one for every 3 FMAs);
// 2. u comes from HBM about once (a y-z halo of ~1.4x served by L2, and
//    one extra element plane per x chunk) instead of ~9 times through L2;
// 3. no per-pair index arithmetic: each thread's staging offsets and
//    corner rows are computed once, the y-z tile being fixed while the
//    block walks x;
// and the reflection product does 2.7x fewer operations than 576 FMAs.
// A split-TF32 tensor-core product (mma.sync, three terms) was the first
// design: it put the 257^3 compliance 11.6% off the golden, because the
// solver's smooth Krylov vectors cancel 4-5 digits in the node sums, and
// the reflection product was faster anyway (PERF.md).
//
// The bf16 build, K1-bf16 (hex_operator_bf16), has a body of its own,
// the column body below.  It computes what the f32 build computes on the
// inputs widened to f32: every operation in f32, each stored value
// widened once, out rounded to nearest even once, no atomics.
//
// What bounds K1-bf16 on an H100 at 257^3 nodes: 237 MB of compulsory
// traffic, 0.0708 ms at 3.35 TB/s.  Its operations for a brick's KE
// (ops/roofline.py: 192 FLOP per element, 9 per node) come to 3.4 GFLOP,
// 0.050 ms at the 67 TFLOP/s f32 peak; as issued instructions (~168 f32
// ones per element) the f32 pipes alone would need ~0.10 ms at 1.755 GHz
// (an estimate from the counts), and every load, store, conversion,
// address and branch adds to that: an SM issues one warp instruction per
// clock per scheduler, the f32 pipes' rate.  So issued instructions and
// their stalls set its pace.  The tile body it replaced (0.53 ms at
// 257^3 on an NVIDIA H100 80GB HBM3 at 700 W, PERF.md) made 48 shared
// accesses per element and two barriers per element plane, computed 20%
// of its products twice on a halo, left 7% of its threads idle and 52 of
// 132 SMs a third idle.
//
// Column design.  A block owns a tile of element columns in y-z, one per
// thread (15 x 34 columns, 14 x 33 owned nodes, 512 threads from 2^17
// nodes; 7 x 34 and 256 threads below, where a launch's latency sets the
// time), and walks x: each step is one element plane.  The element
// product is the brick's reflection-block product (hex_tile.cuh) with the
// 8-point Walsh-Hadamard transform split into its y-z half (4 points, per
// node plane) and its x butterfly:
// 1. the x-halves in registers.  A thread keeps its column's node plane
//    x + 1, already half-transformed, as the next element's x half: a
//    step loads 12 words of u and transforms one half (24 adds), not two.
//    It keeps the forces' ox = 1 half (E applied, still y-z transformed)
//    and adds it to the next element's ox = 0 half, so one inverse
//    half-transform (24 adds) gives the column's four corner forces on
//    node plane x.  The signs of D (the reflections' flips of
//    components) fold into those sums;
// 2. one barrier per step.  The columns exchange those forces through a
//    double-buffered float4 array in shared memory (4 16-byte stores per
//    column, 4 16-byte loads per owned node, which sums its 4 columns),
//    so step x + 1's stores never meet step x's loads: 8 shared accesses
//    per element, not 48;
// 3. a wider tile: 510 columns for 462 owned nodes, a 10% halo;
// 4. a grid that fills the card evenly and walks it together: block
//    (tz, q) of a (z tiles, Q) grid takes share q of z tile column tz's
//    (y tile, node plane) pairs, Q as many as the card holds at once over
//    the z tiles (at 257^3 8 z tiles x 16 shares, 128 blocks on 132
//    SMs), so every block has one wave's equal share, and the blocks of
//    one share walk the same node planes of the z tiles of a y row
//    together: their loads and stores meet in the same DRAM rows and L2
//    sectors, where one block per SM walking its share in tile order
//    leaves each tile's neighbours at other planes
//    (tools/torch_k1bf16_ablations.py times both; PERF.md section 6).  A
//    share starts each run of planes with one extra element plane, ~1%
//    at 257^3;
// 5. staging: none.  A thread loads its column's 12 words of u and its
//    E straight from device memory through L1 (16-bit loads; a node is a
//    corner of 4 columns, so L1 serves 3 of the 4 reads), two steps ahead
//    into registers: no shared memory holds u and no barrier guards it.
//    cp.async copies 4, 8 or 16 aligned bytes, and a bf16 z-row of a
//    2^k + 1 extent starts at either parity; TMA's 16-byte strides do not
//    fit it either;
// 6. fewer products: a brick's blocks Q_k fill 45 of their 72 entries
//    (translations and rotations leave their modes' rows empty); the
//    host checks each KE's blocks against that pattern, to 1e-6 of their
//    largest entry, beside the symmetry.  No tensor cores: the
//    split-TF32 product put the compliance 11.6% off (above).
// A KE without the symmetry or the pattern takes the 576-FMA product on
// raw halves, with the same carries and exchange.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <algorithm>
#include <type_traits>

#include "hex_tile.cuh"

namespace {

using namespace hex_tile;

// -- K1: the tile body (hex_tile.cuh) -------------------------------------- //

// A block owns 6 x 33 nodes, one element per thread: 7 x 34 elements, so
// that the 2^k + 1 node extents of the multigrid levels nearly fill their
// z tiles (33 in one, 65 in two, 129 in four, 257 in eight).
constexpr int K1_TY = 6, K1_TZ = 33, K1_NT = 256;
constexpr int K1_SMEM = Tile<K1_TY, K1_TZ, K1_NT, 3>::kBytes;

// kSym: the element product by the reflection blocks, else 576 FMAs
// (hex_tile.cuh).  The two builds are two kernels, so that a profile
// tells them apart by name.
template <bool kSym>
__global__ void __launch_bounds__(K1_NT, 3)
hex_operator_kernel(const float* __restrict__ u, const float* __restrict__ E,
                    float* __restrict__ out,
                    const __grid_constant__ KEParams ke, int nx, int ny,
                    int nz, int xc, int mask_x0) {
  tile_operator<K1_TY, K1_TZ, K1_NT, 3, false, kSym>(u, E, out, ke, nx, ny,
                                                     nz, xc, mask_x0);
}

// Launches K1 on an nx x ny x nz grid, or only returns its grid when ke
// is null.
template <bool kSym>
dim3 launch_f32(const float* u, const float* E, float* out,
                const KEParams* ke, int nx, int ny, int nz, int mask_x0,
                cudaStream_t stream) {
  int xc;
  const dim3 grid = tile_grid<hex_operator_kernel<kSym>, K1_TY, K1_TZ, K1_NT>(
      nx, ny, nz, K1_SMEM, &xc);
  if (ke)
    hex_operator_kernel<kSym><<<grid, K1_NT, K1_SMEM, stream>>>(
        u, E, out, *ke, nx, ny, nz, xc, mask_x0);
  return grid;
}

// -- K1-bf16: the column body ---------------------------------------------- //

namespace column {

// A block of NT threads owns a tile of CY x CZ element columns (one per
// thread), holding every element of its (CY - 1) x (CZ - 1) nodes, and
// walks runs of at least kMinPlanes node planes along x; kOcc blocks fit
// on an SM (__launch_bounds__).
template <int NT_, int CY_, int kOcc_, int kMinPlanes_>
struct Shape {
  static constexpr int NT = NT_, CY = CY_, CZ = 34;
  static constexpr int kOcc = kOcc_, kMinPlanes = kMinPlanes_;
  static constexpr int NC = CY * CZ, TY = CY - 1, TZ = CZ - 1;
  // the force exchange: two buffers (by step parity) of NT float4 for
  // each of a column's 4 y-z corners
  static constexpr int kSmem = 2 * 4 * NT * static_cast<int>(sizeof(float4));
  static_assert(NC <= NT, "one column per thread");
};
// The fine levels: 15 x 34 columns, 14 x 33 nodes, so that the 2^k + 1
// extents fill their z tiles to 3% and y to 4-11%.
using Wide = Shape<512, 15, 1, 2>;
// Grids below kNarrowNodes nodes, where a launch's latency sets its
// time: more, smaller blocks, each walking runs from one plane.
using Narrow = Shape<256, 7, 2, 1>;
constexpr long kNarrowNodes = 1L << 17;

// corner m = oy | oz << 1 of a column's face in a node plane
__host__ __device__ constexpr int my(int m) { return m & 1; }
__host__ __device__ constexpr int mz(int m) { return m >> 1; }
// whether D_yz(m), the y and z reflections' part of D, flips component i
__host__ __device__ constexpr bool yz_flips(int m, int i) {
  return (i == 1 && my(m)) || (i == 2 && mz(m));
}

// The entries of the blocks Q_k that a brick's KE can make nonzero, bit
// 3 i + j of row i, column j: translations and rotations leave their
// modes' rows and columns empty (tests/test_torch_hex_tiles.py holds the
// pattern for bricks of any sides and Poisson ratio).
__host__ __device__ constexpr unsigned block_pattern(int k) {
  return k == 0 || k == 7 ? 0777u
         : k == 1         ? 0660u
         : k == 2         ? 0505u
         : k == 3         ? 0433u
         : k == 4         ? 0033u
         : k == 5         ? 0525u
                          : 0661u;
}
__host__ __device__ constexpr bool in_block(int k, int i, int j) {
  return (block_pattern(k) >> (3 * i + j)) & 1u;
}
__host__ __device__ constexpr bool empty_row(int k, int i) {
  return !((block_pattern(k) >> (3 * i)) & 7u);
}
// whether KE's blocks keep the pattern, to 1e-6 of their largest entry
// (the f32 rounding of a brick's KE leaves ~2e-8)
inline bool has_block_pattern(const KEParams& ke) {
  float scale = 0.f, off = 0.f;
  for (int k = 0; k < 8; ++k)
    for (int i = 0; i < 3; ++i)
      for (int j = 0; j < 3; ++j) {
        const float q = fabsf(ke.q[9 * k + 3 * i + j]);
        scale = fmaxf(scale, q);
        if (!in_block(k, i, j)) off = fmaxf(off, q);
      }
  return off <= 1e-6f * scale;
}

// a node plane's values at a column's 4 corners, [m][component]
using Half = float[4][3];

// the 4-point Walsh-Hadamard transform over m (oy, then oz), per component
__device__ __forceinline__ void wht4(Half& h) {
#pragma unroll
  for (int s = 1; s < 4; s <<= 1)
#pragma unroll
    for (int m = 0; m < 4; ++m)
      if (!(m & s))
#pragma unroll
        for (int i = 0; i < 3; ++i) {
          const float a = h[m][i], b = h[m | s][i];
          h[m][i] = a + b;
          h[m | s][i] = a - b;
        }
}

// a node plane's half as the element products take it: WHT_yz(D_yz h)
// for the reflection product, h itself for the FMA product
template <bool kSym>
__device__ __forceinline__ void forward(Half& h) {
  if constexpr (kSym) {
#pragma unroll
    for (int m = 0; m < 4; ++m)
#pragma unroll
      for (int i = 0; i < 3; ++i)
        if (yz_flips(m, i)) h[m][i] = -h[m][i];
    wht4(h);
  }
}

// The element between node planes x (half w0) and x + 1 (half w1), scaled
// by e: the half of its forces on plane x into f0 and the half on plane
// x + 1 into f1.  Reflection product: V = WHT(D u_e) is the x butterfly
// of w0 and Dx w1 (corner bits ox | m << 1; Dx flips component 0), y_k =
// e Q_k V_k over the entries of the pattern, and the inverse x butterfly
// gives f0 and Dx f1, y-z transformed (Dx, and D_yz after the inverse
// y-z transform, are applied where the halves are summed).
template <bool kSym>
__device__ __forceinline__ void element(const Half& w0, const Half& w1,
                                        float e, const KEParams& ke,
                                        Half& f0, Half& f1) {
  if constexpr (kSym) {
    float v[8][3];
#pragma unroll
    for (int m = 0; m < 4; ++m)
#pragma unroll
      for (int i = 0; i < 3; ++i) {
        const float b = i == 0 ? -w1[m][i] : w1[m][i];
        v[m << 1][i] = w0[m][i] + b;
        v[m << 1 | 1][i] = w0[m][i] - b;
      }
    float y[8][3];
#pragma unroll
    for (int k = 0; k < 8; ++k)
#pragma unroll
      for (int i = 0; i < 3; ++i) {
        float acc = 0.f;
#pragma unroll
        for (int j = 0, n = 0; j < 3; ++j)
          if (in_block(k, i, j)) {
            const float q = ke.q[9 * k + 3 * i + j];
            acc = n++ ? fmaf(q, v[k][j], acc) : q * v[k][j];
          }
        y[k][i] = e * acc;
      }
#pragma unroll
    for (int m = 0; m < 4; ++m)
#pragma unroll
      for (int i = 0; i < 3; ++i) {
        const float a = y[m << 1][i], b = y[m << 1 | 1][i];
        const bool za = empty_row(m << 1, i), zb = empty_row(m << 1 | 1, i);
        f0[m][i] = za ? b : zb ? a : a + b;
        f1[m][i] = za ? -b : zb ? a : a - b;
      }
  } else {
    float ue[24], f[24];
#pragma unroll
    for (int a = 0; a < 8; ++a)
#pragma unroll
      for (int i = 0; i < 3; ++i)
        ue[3 * a + i] = (ox(a) ? w1 : w0)[oy(a) | oz(a) << 1][i];
    element_product<3>(ue, ke, f);
#pragma unroll
    for (int a = 0; a < 8; ++a)
#pragma unroll
      for (int i = 0; i < 3; ++i)
        (ox(a) ? f1 : f0)[oy(a) | oz(a) << 1][i] = e * f[3 * a + i];
  }
}

// the sign of the ox = 1 half's component i where it is summed (Dx), and
// of corner m's component i in a node's sum (D_yz), for the reflection
// product; the FMA product's halves are forces already
template <bool kSym>
__device__ __forceinline__ float carry_sign(int i) {
  return kSym && i == 0 ? -1.f : 1.f;
}
template <bool kSym>
__device__ __forceinline__ float corner_sign(int m, int i) {
  return kSym && yz_flips(m, i) ? -1.f : 1.f;
}

// a bf16 value's bits widened to f32: exact, bf16 being an f32's upper
// half
__device__ __forceinline__ float widen(unsigned short bits) {
  return __uint_as_float(static_cast<unsigned>(bits) << 16);
}

// a step's loads: node plane x + 1 at the column's 4 corners and element
// x's E, as stored
struct Stage {
  unsigned short u[4][3];
  unsigned short e;
};

}  // namespace column

// out = K(E) u on bf16 storage.  Block (tz, q) of a (z tiles, Q) grid
// takes share q of z tile column tz's (y tile, node plane) pairs, in
// order, so that the blocks of one share walk the same planes of
// neighbouring tiles together.  A run of node planes [xa, xb) of one tile
// takes the element planes max(xa - 1, 0) .. min(xb - 1, nx - 2); each
// step forms its element's forces from the carried half of node plane x
// and the loaded one of x + 1, adds the carried ox = 1 forces of element
// x - 1, and (for x >= xa) hands the column's corner forces on node plane
// x to the owners of its nodes, which sum their 4 columns in the order m
// = 0, 1, 2, 3 (the node's corner m) and write node plane x.  The grid's
// last node plane takes the last carry alone.  A column outside the grid
// loads nothing and computes zeros.
template <class S, bool kSym>
__global__ void __launch_bounds__(S::NT, S::kOcc)
hex_operator_bf16_kernel(const __nv_bfloat16* __restrict__ u,
                         const __nv_bfloat16* __restrict__ E,
                         __nv_bfloat16* __restrict__ out,
                         const __grid_constant__ KEParams ke, int nx,
                         int ny, int nz, int mask_x0) {
  using namespace column;
  constexpr int NT = S::NT, CZ = S::CZ, TY = S::TY, TZ = S::TZ;
  extern __shared__ float4 xbuf[];  // [parity][m][column]
  const int gy = (ny + TY - 1) / TY;
  const long work = static_cast<long>(gy) * nx;  // of this z tile column
  long w = work * blockIdx.y / gridDim.y;
  const long w_end = work * (blockIdx.y + 1) / gridDim.y;
  const auto* ub = reinterpret_cast<const unsigned short*>(u);
  const auto* eb = reinterpret_cast<const unsigned short*>(E);
  const int plane = ny * nz, eplane = (ny - 1) * (nz - 1);
  const int nnode = nx * plane;
  const int t = threadIdx.x;
  const int cy = t / CZ, cz = t - cy * CZ;  // this thread's column
  const int ny0 = t / TZ, nz0 = t - ny0 * TZ;  // and owned node
  // the column holding the owned node as corner m: cbase - my CZ - mz
  const int cbase = (ny0 + 1) * CZ + nz0 + 1;
  const int z0 = blockIdx.x * TZ;
  int parity = 0;

  while (w < w_end) {
    const int ty = static_cast<int>(w / nx);
    const int xa = static_cast<int>(w - static_cast<long>(ty) * nx);
    const long left = w_end - w;
    const int xb = left < nx - xa ? xa + static_cast<int>(left) : nx;
    w += xb - xa;
    const int y0 = ty * TY;
    // the column's element (ey, ez): all 4 of its corner nodes lie in
    // the grid when it does
    const int ey = y0 - 1 + cy, ez = z0 - 1 + cz;
    const bool valid = t < S::NC && ey >= 0 && ey < ny - 1 && ez >= 0 &&
                       ez < nz - 1;
    const int coff = ey * nz + ez, eoff = ey * (nz - 1) + ez;
    const int oy_ = y0 + ny0, oz_ = z0 + nz0;
    const bool owner = t < TY * TZ && oy_ < ny && oz_ < nz;
    const int ooff = oy_ * nz + oz_;
    const int e_lo = max(xa - 1, 0), e_hi = min(xb - 1, nx - 2);

    // node plane x + 1's corners and element x's E, into s
    auto fetch = [&](Stage& s, int x) {
      if (valid && x <= e_hi) {
        const unsigned short* p = ub + (x + 1) * plane + coff;
#pragma unroll
        for (int m = 0; m < 4; ++m)
#pragma unroll
          for (int i = 0; i < 3; ++i)
            s.u[m][i] = __ldg(p + i * nnode + my(m) * nz + mz(m));
        s.e = __ldg(eb + x * eplane + eoff);
      }
    };
    // node plane x's sums from the columns' y-z transformed corner
    // forces g
    auto emit = [&](int x, Half& g) {
      if constexpr (kSym) wht4(g);
      float4* buf = xbuf + parity * 4 * NT;
#pragma unroll
      for (int m = 0; m < 4; ++m)
        buf[m * NT + t] = make_float4(g[m][0], g[m][1], g[m][2], 0.f);
      __syncthreads();
      if (owner) {
        float4 v[4];
#pragma unroll
        for (int m = 0; m < 4; ++m)
          v[m] = buf[m * NT + cbase - my(m) * CZ - mz(m)];
        float acc[3] = {v[0].x, v[0].y, v[0].z};
#pragma unroll
        for (int m = 1; m < 4; ++m) {
          acc[0] += corner_sign<kSym>(m, 0) * v[m].x;
          acc[1] += corner_sign<kSym>(m, 1) * v[m].y;
          acc[2] += corner_sign<kSym>(m, 2) * v[m].z;
        }
        const bool zero = mask_x0 && x == 0;
#pragma unroll
        for (int i = 0; i < 3; ++i)
          out[i * nnode + x * plane + ooff] =
              __float2bfloat16_rn(zero ? 0.f : acc[i]);
      }
      parity ^= 1;
    };
    // element x from stage s: half w0 in, w1 out; carried forces fin in,
    // fout out
    auto step = [&](int x, Stage& s, const Half& w0, Half& w1,
                    const Half& fin, Half& fout) {
#pragma unroll
      for (int m = 0; m < 4; ++m)
#pragma unroll
        for (int i = 0; i < 3; ++i) w1[m][i] = widen(s.u[m][i]);
      const float e = widen(s.e);
      fetch(s, x + 2);
      forward<kSym>(w1);
      Half g;
      element<kSym>(w0, w1, e, ke, g, fout);
#pragma unroll
      for (int m = 0; m < 4; ++m)
#pragma unroll
        for (int i = 0; i < 3; ++i)
          g[m][i] = carry_sign<kSym>(i) * fin[m][i] + g[m][i];
      if (x >= xa) emit(x, g);
    };

    // a column outside the grid keeps zeros in every register it loads
    // into, and so computes zero forces
    Half wa, wb, fa, fb;
    Stage s0, s1;
#pragma unroll
    for (int m = 0; m < 4; ++m)
#pragma unroll
      for (int i = 0; i < 3; ++i) {
        wa[m][i] = fa[m][i] = 0.f;
        s0.u[m][i] = s1.u[m][i] = 0;
      }
    s0.e = s1.e = 0;
    if (valid) {
      const unsigned short* p = ub + e_lo * plane + coff;
#pragma unroll
      for (int m = 0; m < 4; ++m)
#pragma unroll
        for (int i = 0; i < 3; ++i)
          wa[m][i] = widen(__ldg(p + i * nnode + my(m) * nz + mz(m)));
      forward<kSym>(wa);
    }
    fetch(s0, e_lo);
    fetch(s1, e_lo + 1);
    // two steps per trip, the halves and carries trading places
    for (int x = e_lo;;) {
      step(x, s0, wa, wb, fa, fb);
      if (++x > e_hi) break;
      step(x, s1, wb, wa, fb, fa);
      if (++x > e_hi) break;
    }
    // node plane nx - 1: the last element's carry alone
    auto last = [&](Half& f) {
#pragma unroll
      for (int m = 0; m < 4; ++m)
#pragma unroll
        for (int i = 0; i < 3; ++i) f[m][i] *= carry_sign<kSym>(i);
      emit(e_hi + 1, f);
    };
    if (e_hi + 1 < xb) {
      if ((e_hi - e_lo) % 2 == 0) last(fb);
      else last(fa);
    }
  }
}

// Launches K1-bf16 of shape S on an nx x ny x nz grid, or only returns its
// grid when ke is null: (z tiles, Q), Q shares per z tile column, as many
// as the card holds at once with each share at least S::kMinPlanes.
template <class S, bool kSym>
dim3 launch_shape(const __nv_bfloat16* u, const __nv_bfloat16* E,
                  __nv_bfloat16* out, const KEParams* ke, int nx, int ny,
                  int nz, int mask_x0, cudaStream_t stream) {
  const int gy = (ny + S::TY - 1) / S::TY, gz = (nz + S::TZ - 1) / S::TZ;
  const long work = static_cast<long>(gy) * nx;
  const long slots =
      resident_blocks<hex_operator_bf16_kernel<S, kSym>>(S::NT, S::kSmem);
  const long shares = std::min(std::max(slots / gz, 1L),
                               (work + S::kMinPlanes - 1) / S::kMinPlanes);
  const dim3 grid(gz, static_cast<unsigned>(shares));
  if (ke)
    hex_operator_bf16_kernel<S, kSym><<<grid, S::NT, S::kSmem, stream>>>(
        u, E, out, *ke, nx, ny, nz, mask_x0);
  return grid;
}

template <bool kSym>
dim3 launch_bf16(const __nv_bfloat16* u, const __nv_bfloat16* E,
                 __nv_bfloat16* out, const KEParams* ke, int nx, int ny,
                 int nz, int mask_x0, cudaStream_t stream) {
  if (static_cast<long>(nx) * ny * nz < column::kNarrowNodes)
    return launch_shape<column::Narrow, kSym>(u, E, out, ke, nx, ny, nz,
                                              mask_x0, stream);
  return launch_shape<column::Wide, kSym>(u, E, out, ke, nx, ny, nz,
                                          mask_x0, stream);
}

// Launches the build of storage type T, or only returns its grid when ke
// is null.
template <class T, bool kSym>
dim3 launch_build(const T* u, const T* E, T* out, const KEParams* ke, int nx,
                  int ny, int nz, int mask_x0, cudaStream_t stream) {
  if constexpr (std::is_same_v<T, float>)
    return launch_f32<kSym>(u, E, out, ke, nx, ny, nz, mask_x0, stream);
  else
    return launch_bf16<kSym>(u, E, out, ke, nx, ny, nz, mask_x0, stream);
}

template <class T>
int launch(const void* u, const void* E, void* out, const void* ke_host,
           int nx, int ny, int nz, int mask_x0, void* stream) {
  if (nx < 2 || ny < 2 || nz < 2)
    return static_cast<int>(cudaErrorInvalidValue);
  KEParams ke;
  bool sym = element_params(static_cast<const float*>(ke_host), &ke);
  if constexpr (!std::is_same_v<T, float>)
    sym = sym && column::has_block_pattern(ke);
  const auto* pu = static_cast<const T*>(u);
  const auto* pE = static_cast<const T*>(E);
  auto* po = static_cast<T*>(out);
  auto st = static_cast<cudaStream_t>(stream);
  if (sym)
    launch_build<T, true>(pu, pE, po, &ke, nx, ny, nz, mask_x0, st);
  else
    launch_build<T, false>(pu, pE, po, &ke, nx, ny, nz, mask_x0, st);
  return static_cast<int>(cudaGetLastError());
}

template <class T>
int grid_of(int nx, int ny, int nz, int* grid3) {
  const dim3 g = launch_build<T, true>(nullptr, nullptr, nullptr, nullptr,
                                       nx, ny, nz, 0, nullptr);
  grid3[0] = g.x;
  grid3[1] = g.y;
  grid3[2] = g.z;
  return 0;
}

}  // namespace

extern "C" {

// u, E, out: device pointers, f32 for hex_operator_f32 and bf16 for
// hex_operator_bf16; ke_host: host pointer to the row-major (24, 24) f32
// element matrix; stream: a cudaStream_t.  The element product is by the
// reflection blocks if KE has the symmetry, else 576 FMAs.  Each launches
// on `stream`, allocates nothing and returns cudaGetLastError().
int hex_operator_f32(const void* u, const void* E, void* out,
                     const void* ke_host, int nx, int ny, int nz,
                     int mask_x0, void* stream) {
  return launch<float>(u, E, out, ke_host, nx, ny, nz, mask_x0, stream);
}

int hex_operator_bf16(const void* u, const void* E, void* out,
                      const void* ke_host, int nx, int ny, int nz,
                      int mask_x0, void* stream) {
  return launch<__nv_bfloat16>(u, E, out, ke_host, nx, ny, nz, mask_x0,
                               stream);
}

// The launch grids of hex_operator_f32 (z tiles, y tiles, x chunks) and
// hex_operator_bf16 (z tiles, its blocks over z tiles rounded up) on an
// nx x ny x nz grid for a KE with the reflection symmetry, into
// grid3[3]: a profile tells the grid levels apart by them.
int hex_operator_grid(int nx, int ny, int nz, int* grid3) {
  return grid_of<float>(nx, ny, nz, grid3);
}

int hex_operator_bf16_grid(int nx, int ny, int nz, int* grid3) {
  return grid_of<__nv_bfloat16>(nx, ny, nz, grid3);
}

const char* topopt_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
