// K2: per-element quadratic form  q[e] = u_e^T KE u_e  (dof = 3, f32).
//
// Replaces the TPU kernel topopt_in_petsc_tpu/ops/pallas_hex.py::_qf_kernel
// (built by make_pallas_quadform).  Plain PyTorch version:
// ops/hex_operator.py::element_quadratic_form.
//
// Layout: u is the nodal (nx, ny, nz, 3) field, q the element field
// (nx-1, ny-1, nz-1), both contiguous with the last axis fastest.  One
// thread per element gathers its 24 dofs, forms w = KE u_e and q = u_e . w.
//
// What bounds it on an H100: 576 f32 FMAs per element against ~16 bytes of
// compulsory traffic (one nodal triple read, one value written), so the
// FMA pipes set the floor (about 0.3 ms at 256^3 elements); the 8-corner
// gather reads each node 8 times, which L1/L2 serve since neighbouring
// threads read neighbouring nodes.  KE is a __grid_constant__ kernel
// parameter with compile-time offsets (constant bank, no device loads),
// and the 24 gathered values stay in registers.  It runs once per
// optimization iteration (objective and sensitivity share its output),
// against the solve's hundreds of K1 launches, so it is kept simple.

#include <cuda_runtime.h>

namespace {

struct KE24q {
  float v[576];  // row-major (24, 24)
};

__host__ __device__ constexpr int cx(int a) { return ((a + 1) >> 1) & 1; }
__host__ __device__ constexpr int cy(int a) { return (a >> 1) & 1; }
__host__ __device__ constexpr int cz(int a) { return a >> 2; }

__global__ void __launch_bounds__(256)
quadform_kernel(const float* __restrict__ u, float* __restrict__ q,
                const __grid_constant__ KE24q ke, int nx, int ny, int nz) {
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
    const int node = ((i + cx(a)) * ny + (j + cy(a))) * nz + k + cz(a);
    ue[3 * a + 0] = __ldg(u + 3 * node + 0);
    ue[3 * a + 1] = __ldg(u + 3 * node + 1);
    ue[3 * a + 2] = __ldg(u + 3 * node + 2);
  }
  float acc = 0.f;
#pragma unroll
  for (int r = 0; r < 24; ++r) {
    float w = 0.f;
#pragma unroll
    for (int c = 0; c < 24; ++c) w = fmaf(ke.v[r * 24 + c], ue[c], w);
    acc = fmaf(ue[r], w, acc);
  }
  q[e] = acc;
}

}  // namespace

extern "C" {

// u, q: device pointers; ke_host: host pointer to the row-major (24, 24)
// f32 element matrix; stream: a cudaStream_t.  Launches on `stream`,
// allocates nothing, returns cudaGetLastError().
int quadform_f32(const void* u, void* q, const void* ke_host, int nx, int ny,
                 int nz, void* stream) {
  KE24q ke;
  const float* src = static_cast<const float*>(ke_host);
  for (int i = 0; i < 576; ++i) ke.v[i] = src[i];
  const int nelem = (nx - 1) * (ny - 1) * (nz - 1);
  if (nelem > 0) {
    const int block = 256;
    const int grid = (nelem + block - 1) / block;
    quadform_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(u), static_cast<float*>(q), ke, nx, ny, nz);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
