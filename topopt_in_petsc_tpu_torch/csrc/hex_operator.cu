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
// What bounds it on an H100, at 257^3 nodes: 475 MB of compulsory
// traffic in f32 (u and E read, out written), 0.142 ms at 3.35 TB/s, and
// half of it in bf16, 0.071 ms.  The operations are fewer: the reflection
// product below, the E scaling and the node sums come to 5.2 GFLOP, 0.077
// ms at the 67 TFLOP/s f32 peak (576 FMAs per element would be 19.3
// GFLOP, 0.289 ms; ops/roofline.py), so the bf16 build is bound by its
// operations.
//
// Design (hex_tile.cuh).  A block owns a 6 x 33 node tile in y-z (so the
// 2^k + 1 extents of the multigrid levels fill whole tiles in z) and a
// chunk of x, whose length x_chunk picks from the grid and the card's
// occupancy.  Walking x, it stages node planes of u (one-node halo) and
// element planes of E in shared memory by cp.async, kStages planes ahead
// of the compute.  For each element plane it forms f_e = E_e * (u_e @ KE)
// for the 7 x 34 elements that touch the tile, one element per thread,
// into shared memory; then each node sums its corners in a fixed order:
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
// The bf16 build is the same body on bf16 storage (hex_tile.cuh): each
// staged value widened to f32 once, the same products and node-sum order,
// out rounded to nearest even once; deterministic like the f32 build.
// Its planes are loaded into registers a step ahead instead of by
// cp.async, whose 4-byte copies a bf16 row of either parity does not fit.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <type_traits>

#include "hex_tile.cuh"

namespace {

using namespace hex_tile;

// A block owns 6 x 33 nodes, one element per thread: 7 x 34 elements, so
// that the 2^k + 1 node extents of the multigrid levels nearly fill their
// z tiles (33 in one, 65 in two, 129 in four, 257 in eight).
constexpr int TY = 6, TZ = 33, NT = 256;
constexpr int kSmem = Tile<TY, TZ, NT, 3>::kBytes;

// kSym: the element product by the reflection blocks, else 576 FMAs
// (hex_tile.cuh).  The two builds are two kernels, so that a profile
// tells them apart by name.
template <bool kSym>
__global__ void __launch_bounds__(NT, 3)
hex_operator_kernel(const float* __restrict__ u, const float* __restrict__ E,
                    float* __restrict__ out,
                    const __grid_constant__ KEParams ke, int nx, int ny,
                    int nz, int xc, int mask_x0) {
  tile_operator<TY, TZ, NT, 3, false, kSym>(u, E, out, ke, nx, ny, nz, xc,
                                            mask_x0);
}

template <bool kSym>
__global__ void __launch_bounds__(NT, 3)
hex_operator_bf16_kernel(const __nv_bfloat16* __restrict__ u,
                         const __nv_bfloat16* __restrict__ E,
                         __nv_bfloat16* __restrict__ out,
                         const __grid_constant__ KEParams ke, int nx,
                         int ny, int nz, int xc, int mask_x0) {
  tile_operator<TY, TZ, NT, 3, false, kSym>(u, E, out, ke, nx, ny, nz, xc,
                                            mask_x0);
}

// Launches the kernel of storage type T on an nx x ny x nz grid, or only
// returns its grid when ke is null.
template <class T, bool kSym>
dim3 launch_tile(const T* u, const T* E, T* out, const KEParams* ke, int nx,
                 int ny, int nz, int mask_x0, cudaStream_t stream) {
  int xc;
  if constexpr (std::is_same_v<T, float>) {
    const dim3 grid = tile_grid<hex_operator_kernel<kSym>, TY, TZ, NT>(
        nx, ny, nz, kSmem, &xc);
    if (ke)
      hex_operator_kernel<kSym><<<grid, NT, kSmem, stream>>>(
          u, E, out, *ke, nx, ny, nz, xc, mask_x0);
    return grid;
  } else {
    const dim3 grid = tile_grid<hex_operator_bf16_kernel<kSym>, TY, TZ, NT>(
        nx, ny, nz, kSmem, &xc);
    if (ke)
      hex_operator_bf16_kernel<kSym><<<grid, NT, kSmem, stream>>>(
          u, E, out, *ke, nx, ny, nz, xc, mask_x0);
    return grid;
  }
}

template <class T>
int launch(const void* u, const void* E, void* out, const void* ke_host,
           int nx, int ny, int nz, int mask_x0, void* stream) {
  if (nx < 2 || ny < 2 || nz < 2)
    return static_cast<int>(cudaErrorInvalidValue);
  KEParams ke;
  const bool sym = element_params(static_cast<const float*>(ke_host), &ke);
  const auto* pu = static_cast<const T*>(u);
  const auto* pE = static_cast<const T*>(E);
  auto* po = static_cast<T*>(out);
  auto st = static_cast<cudaStream_t>(stream);
  if (sym)
    launch_tile<T, true>(pu, pE, po, &ke, nx, ny, nz, mask_x0, st);
  else
    launch_tile<T, false>(pu, pE, po, &ke, nx, ny, nz, mask_x0, st);
  return static_cast<int>(cudaGetLastError());
}

template <class T>
int grid_of(int nx, int ny, int nz, int* grid3) {
  const dim3 g = launch_tile<T, true>(nullptr, nullptr, nullptr, nullptr, nx,
                                      ny, nz, 0, nullptr);
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

// The launch grids of hex_operator_f32 and hex_operator_bf16 on an nx x
// ny x nz grid for a KE with the reflection symmetry, into grid3[3] (z
// tiles, y tiles, x chunks): a profile tells the grid levels apart by
// them.
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
