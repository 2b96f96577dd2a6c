// K3 and K4: the matrix-free Hex8 operator  out = K(E) u  on the nodal
// layout, free (Neumann) boundaries, f32, as tile kernels on the body
// K1 runs (hex_tile.cuh, `tile_operator`):
//
//   K3  helmholtz_f32  DOF 1, KF (8, 8): the Helmholtz PDE-filter operator
//       (-R^2 lap + I) with a unit element scale.  Replaces the TPU kernel
//       topopt_in_petsc_tpu/ops/pallas_hex.py::_kernel1 (built by
//       make_pallas_helmholtz_apply).
//   K4  nodal_hex_f32  DOF 3, KE (24, 24): the elasticity operator of the
//       nodal solve (-operator_impl pallas).  Replaces the TPU kernel
//       topopt_in_petsc_tpu/ops/pallas_hex.py::_kernel (built by
//       make_pallas_hex_apply).
//
// Plain PyTorch version of both: ops/hex_operator.py::apply_hex_operator.
//
//   out[n] = sum over the (up to) 8 elements e with node n as corner a of
//            E_e * (u_e @ KE)[DOF a : DOF a + DOF]
//
// Layout: u and out are (nx, ny, nz, DOF), E is (nx-1, ny-1, nz-1), all
// contiguous with the last axis fastest: the layout of the JAX package's
// interface, with no pads, halo lanes or y-chunk windows (those served
// Mosaic's DMA limits only).  The Dirichlet masks stay outside the
// kernels (solvers/multigrid.py, GeometricMultigrid.apply).
//
// What bounds them on an H100 (ops/roofline.py), at 257^3 nodes:
//   K4: 475 MB of compulsory traffic (u and E read, out written), 0.142
//       ms at 3.35 TB/s, as K1; the reflection product, the E scaling and
//       the node sums come to 5.2 GFLOP, 0.077 ms at the 67 TFLOP/s f32
//       peak.
//   K3: 203 MB, 0.061 ms; the scalar reflection product (24 + 24 adds, 8
//       multiplies by Q_k, 8 by E per element, 7 adds per node) comes to
//       1.2 GFLOP, 0.018 ms.
//
// Design.  Each is the tile body of K1 (csrc/hex_operator.cu) on the
// node-major layout without the x = 0 mask: a block owns a y-z node tile
// and a chunk of x, stages node planes of u and element planes of E in
// shared memory by cp.async kStages planes ahead, forms each element's
// E-scaled product once into shared memory, and sums each node's 8
// corners in a fixed order (no atomics: two launches give bitwise-equal
// output).  A y-row of the tile's node plane is one run of DOF x 34
// floats in device memory, copied word by word by consecutive threads;
// out is written in place with a DOF-word stride per thread (for K4 it
// measured as fast as K1's component-major writes, so it is not staged).
// The element products are the brick's reflection products: for K4 the
// 3 x 3 blocks of K1, for K3 a scalar per Walsh-Hadamard mode (Q_k =
// lambda_k / 8); a matrix without the symmetry takes the (8 DOF)^2-FMA
// product (the host checks and caches every matrix; each MG level has its
// own).  What this does about the limits of the kernel it replaced (one
// thread per node gathering its 8 elements' corners through L1: 192
// loads and 576 FMAs per node for K4, 64 loads for K3, a 3-D index per
// corner pair; 0.967 and 0.401 ms at 257^3, 15% of the bounds): each
// element's dofs are read from shared memory once, u comes from device
// memory about once instead of ~9 times through L2, the staging offsets
// are computed once per thread, and the reflection products do 2.7x
// (K4) and 2x (K3) fewer operations.

#include <cuda_runtime.h>

#include "hex_tile.cuh"

namespace {

using namespace hex_tile;

// K4: K1's tile, 6 x 33 nodes (7 x 34 elements), one element per thread.
constexpr int K4_TY = 6, K4_TZ = 33, K4_NT = 256;
constexpr int K4_SMEM = Tile<K4_TY, K4_TZ, K4_NT, 3>::kBytes;
// K3: a DOF-1 plane takes a third of the shared memory of K4's, so a
// block takes twice K4's tile, 12 x 33 nodes (13 x 34 elements, 512
// threads): the fastest of the tiles timed at 257^3 and 129^3, the levels
// where the filter's time goes (6 x 33, 6 x 65, 14 x 33 and 30 x 33 were
// slower; 12 rows fill 257 and 129 to 3%, 65 to 10%).
constexpr int K3_TY = 12, K3_TZ = 33, K3_NT = 512;
constexpr int K3_SMEM = Tile<K3_TY, K3_TZ, K3_NT, 1>::kBytes;

template <bool kSym>
__global__ void __launch_bounds__(K4_NT, 3)
nodal_hex_kernel(const float* __restrict__ u, const float* __restrict__ E,
                 float* __restrict__ out,
                 const __grid_constant__ ElemParams<3> ke, int nx, int ny,
                 int nz, int xc) {
  tile_operator<K4_TY, K4_TZ, K4_NT, 3, true, kSym>(u, E, out, ke, nx, ny,
                                                    nz, xc, 0);
}

template <bool kSym>
__global__ void __launch_bounds__(K3_NT)
helmholtz_kernel(const float* __restrict__ u, const float* __restrict__ E,
                 float* __restrict__ out,
                 const __grid_constant__ ElemParams<1> ke, int nx, int ny,
                 int nz, int xc) {
  tile_operator<K3_TY, K3_TZ, K3_NT, 1, true, kSym>(u, E, out, ke, nx, ny,
                                                    nz, xc, 0);
}

// Launches the DOF kernel on an nx x ny x nz grid, or only returns its
// grid when ke is null.
template <int DOF, bool kSym>
dim3 launch_tile(const float* u, const float* E, float* out,
                 const ElemParams<DOF>* ke, int nx, int ny, int nz,
                 cudaStream_t stream) {
  int xc;
  if constexpr (DOF == 3) {
    const dim3 grid = tile_grid<nodal_hex_kernel<kSym>, K4_TY, K4_TZ, K4_NT>(
        nx, ny, nz, K4_SMEM, &xc);
    if (ke)
      nodal_hex_kernel<kSym><<<grid, K4_NT, K4_SMEM, stream>>>(
          u, E, out, *ke, nx, ny, nz, xc);
    return grid;
  } else {
    const dim3 grid = tile_grid<helmholtz_kernel<kSym>, K3_TY, K3_TZ, K3_NT>(
        nx, ny, nz, K3_SMEM, &xc);
    if (ke)
      helmholtz_kernel<kSym><<<grid, K3_NT, K3_SMEM, stream>>>(
          u, E, out, *ke, nx, ny, nz, xc);
    return grid;
  }
}

template <int DOF>
int launch(const void* u, const void* E, void* out, const void* ke_host,
           int nx, int ny, int nz, void* stream) {
  if (nx < 2 || ny < 2 || nz < 2)
    return static_cast<int>(cudaErrorInvalidValue);
  ElemParams<DOF> ke;
  const bool sym =
      element_params<DOF>(static_cast<const float*>(ke_host), &ke);
  const auto* pu = static_cast<const float*>(u);
  const auto* pE = static_cast<const float*>(E);
  auto* po = static_cast<float*>(out);
  auto st = static_cast<cudaStream_t>(stream);
  if (sym)
    launch_tile<DOF, true>(pu, pE, po, &ke, nx, ny, nz, st);
  else
    launch_tile<DOF, false>(pu, pE, po, &ke, nx, ny, nz, st);
  return static_cast<int>(cudaGetLastError());
}

template <int DOF>
int grid_of(int nx, int ny, int nz, int* grid3) {
  const dim3 g =
      launch_tile<DOF, true>(nullptr, nullptr, nullptr, nullptr, nx, ny, nz,
                             nullptr);
  grid3[0] = g.x;
  grid3[1] = g.y;
  grid3[2] = g.z;
  return 0;
}

}  // namespace

extern "C" {

// u, E, out: device pointers; ke_host: host pointer to the row-major
// element matrix, (8, 8) for helmholtz_f32 and (24, 24) for
// nodal_hex_f32; stream: a cudaStream_t.  The element product is by the
// reflection blocks if the matrix has the symmetry, else (8 DOF)^2 FMAs.
// Each launches on `stream`, allocates nothing and returns
// cudaGetLastError().
int helmholtz_f32(const void* u, const void* E, void* out,
                  const void* ke_host, int nx, int ny, int nz,
                  void* stream) {
  return launch<1>(u, E, out, ke_host, nx, ny, nz, stream);
}

int nodal_hex_f32(const void* u, const void* E, void* out,
                  const void* ke_host, int nx, int ny, int nz,
                  void* stream) {
  return launch<3>(u, E, out, ke_host, nx, ny, nz, stream);
}

// The launch grids of helmholtz_f32 and nodal_hex_f32 on an nx x ny x nz
// grid for a matrix with the reflection symmetry, into grid3[3] (z tiles,
// y tiles, x chunks): a profile tells the grid levels apart by them.
int helmholtz_grid(int nx, int ny, int nz, int* grid3) {
  return grid_of<1>(nx, ny, nz, grid3);
}

int nodal_hex_grid(int nx, int ny, int nz, int* grid3) {
  return grid_of<3>(nx, ny, nz, grid3);
}

}  // extern "C"
