// K2: per-element quadratic form  q[e] = u_e . (u_e @ KE)  (dof = 3, f32).
//
// Replaces the TPU kernel topopt_in_petsc_tpu/ops/pallas_hex.py::_qf_kernel
// (built by make_pallas_quadform).  Plain PyTorch version:
// ops/hex_operator.py::element_quadratic_form.
//
// Layout: u is the nodal (nx, ny, nz, 3) field, q the element field
// (nx-1, ny-1, nz-1), both contiguous with the last axis fastest.
//
// What bounds it on an H100, at 257^3 nodes: 271 MB of compulsory
// traffic (u read, q written), 0.081 ms at 3.35 TB/s.  The operations
// are fewer: the reflection form below comes to 4.0 GFLOP, 0.060 ms at
// the 67 TFLOP/s f32 peak (600 FMAs per element would be 20.1 GFLOP,
// 0.30 ms; ops/roofline.py).
//
// One thread per element gathers its 24 dofs through L1 and forms q by
// the brick's reflection blocks (hex_tile.cuh: u_e . (u_e @ KE) =
// sum_k V_k . Q_k V_k, a Walsh-Hadamard transform over the 8 corners, 72
// adds + 96 FMAs in place of 600 FMAs) when KE has the symmetry, which
// every KE of this package has, else by the 600-FMA product.  A
// shared-memory tile form on hex_tile.cuh (staged node planes) measured
// slower with the reflection product (PERF.md) and was not kept: K2 runs
// once per iteration, each element's dofs feed that element alone, and
// L1 serves the 8-fold node reuse as well as the staging did.
//
// No atomics: two launches give bitwise-equal output.

#include <cuda_runtime.h>

#include "hex_tile.cuh"

namespace {

using namespace hex_tile;

template <bool kSym>
__global__ void __launch_bounds__(256)
quadform_kernel(const float* __restrict__ u, float* __restrict__ q,
                const __grid_constant__ KEParams ke, int nx, int ny, int nz) {
  const int ex = nx - 1, ey = ny - 1, ez = nz - 1;
  const int nelem = ex * ey * ez;
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= nelem) return;
  const int k = e % ez;
  const int t = e / ez;
  const int j = t % ey;
  const int i = t / ey;
  float ue[24];
#pragma unroll
  for (int a = 0; a < 8; ++a) {
    const int node = ((i + ox(a)) * ny + (j + oy(a))) * nz + k + oz(a);
    ue[3 * a + 0] = __ldg(u + 3 * node + 0);
    ue[3 * a + 1] = __ldg(u + 3 * node + 1);
    ue[3 * a + 2] = __ldg(u + 3 * node + 2);
  }
  q[e] = element_quadform<kSym>(ue, ke);
}

}  // namespace

extern "C" {

// u, q: device pointers; ke_host: host pointer to the row-major (24, 24)
// f32 element matrix; stream: a cudaStream_t.  Launches on `stream`,
// allocates nothing, returns cudaGetLastError().
int quadform_f32(const void* u, void* q, const void* ke_host, int nx, int ny,
                 int nz, void* stream) {
  if (nx < 2 || ny < 2 || nz < 2)
    return static_cast<int>(cudaErrorInvalidValue);
  KEParams ke;
  const bool sym = element_params(static_cast<const float*>(ke_host), &ke);
  const int grid = ((nx - 1) * (ny - 1) * (nz - 1) + 255) / 256;
  const auto* pu = static_cast<const float*>(u);
  auto* pq = static_cast<float*>(q);
  auto st = static_cast<cudaStream_t>(stream);
  if (sym)
    quadform_kernel<true><<<grid, 256, 0, st>>>(pu, pq, ke, nx, ny, nz);
  else
    quadform_kernel<false><<<grid, 256, 0, st>>>(pu, pq, ke, nx, ny, nz);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
