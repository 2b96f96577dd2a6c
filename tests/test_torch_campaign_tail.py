"""The post-solve tail of the campaign's fused iteration, the port's against
the JAX package's, stage by stage, on the CPU: K2's per-element uᵀKEu, the
objective and its scaled sensitivity, the density filter's chain rule (the
FFT route), the movelimits, the MMA update and the re-filtered design.

The grid is 65x65x65 nodes with `-rmin 0.32`: rmin/h is (10.24, 20.48,
20.48), as at the campaign's 257³ with `-rmin 0.08`, so the filter is the
campaign's anisotropic hat kernel in a 41³ box (FFT route, transforms of
108 per axis).  Both tails start from the fused step's init state (x at
volfrac, fresh asymptotes, fscale = 10/fx: iteration 1) and the same state
field u, made from a seed with numpy: a bending field with noise, zero at
the clamped face.

- the JAX side is its fused step's tail (`parallel/fused_step.py`
  `tail_head` + `tail_rest`, jitted, x64 as its CLI runs): its CPU route
  (`element_quadratic_form`) and, for K2, the TPU route's Pallas kernel
  `make_pallas_quadform` in interpret mode.  It is read from
  `docs/jax_cpu_campaign_tail_65x65x65.npz` (each field at fixed sample
  points, its largest magnitude, l1 norm, sum and a seeded weighted sum),
  which `PYTHONPATH=. JAX_PLATFORMS=cpu python
  tests/test_torch_campaign_tail.py` writes with a digest of the inputs,
  asserted here;
- the port's side is `tools/torch_campaign_probe.py::tail_stages`, which
  calls the fused step's stage functions in their order; a test holds it
  to `FusedStep`'s own first iteration from the same solve, bit for bit.

Bars: every field within 2e-5 of its largest magnitude at the sample
points, and in its sum and weighted sum within 2e-5 of its l1 norm; fx
rtol 2e-5.  gx[0] (the mean of the pre-loop filter's uniform design less
volfrac) within 2e-6: the JAX CPU's f32 FFT puts it at +1.14e-6, the
port's at -5.1e-9 (the exact value is -2.7e-9, volfrac in f32).  The MMA
update's volume target moves with gx[0] (lambda by ~4,600 per unit gx[0]
here), so its scalars are held to the JAX package's with the JAX gx[0]
given to the port's tail: lambda rtol 2e-5, ch and mnd within 1e-6, x and
xPhys at the field bar.

The same file's `__main__` with `--stages DIR <CLI flags>` compares the
two tails at any size from the state field of a JAX CLI run
(`RestartSol00.npz` of `-fused 1 -maxItr 1` in DIR), and the JAX tail with
the run's own new design (`Restart00.npz`):

    PYTHONPATH=. JAX_PLATFORMS=cpu python tests/test_torch_campaign_tail.py \\
        --stages DIR -nx 257 -ny 257 -nz 257 -nlvls 5 -fused 1
"""

import dataclasses
import importlib.util
import os
import sys

import numpy as np
import pytest
import torch
from jax_snapshots import input_digest, load, save

from topopt_in_petsc_tpu.config import TopOptConfig as JaxConfig
from topopt_in_petsc_tpu_torch.config import TopOptConfig
from topopt_in_petsc_tpu_torch.grid import Grid
from topopt_in_petsc_tpu_torch.ops.hex_operator import element_quadratic_form
from topopt_in_petsc_tpu_torch.opt.filters import filter_stencil_halfwidth
from topopt_in_petsc_tpu_torch.parallel.fused_step import make_fused_step

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WRITER = "tests/test_torch_campaign_tail.py"
SNAPSHOT = os.path.join(REPO, "docs", "jax_cpu_campaign_tail_65x65x65.npz")
ARGS = dict(nx=65, ny=65, nz=65, nlvls=5, rmin=0.32, fused=True)
NN = (ARGS["nx"], ARGS["ny"], ARGS["nz"])
SEED = 20261018
N_SAMPLE = 1024
FIELDS = ("uKu", "dfdx_raw", "dfdx", "dgdx", "xmin", "xmax", "L", "U",
          "x", "xTilde", "xPhys")
SCALARS = ("fx", "gx", "lam", "ch", "mnd")
FIELD_BAR = 2e-5
SCALAR_BARS = {"fx": ("rel", 2e-5), "gx": ("abs", 2e-6),
               "lam": ("rel", 2e-5), "ch": ("abs", 1e-6),
               "mnd": ("abs", 1e-6)}
# the stages after the volume target, held with the JAX gx[0]
MMA_STAGES = ("lam", "ch", "mnd", "x", "xTilde", "xPhys")


def _probe():
    spec = importlib.util.spec_from_file_location(
        "torch_campaign_probe",
        os.path.join(REPO, "tools", "torch_campaign_probe.py"))
    probe = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(probe)
    return probe


def seeded_u(nn, seed=SEED):
    """A state field (nx, ny, nz, 3) in f32: a cantilever's bending (the tip
    bent down in z, a twist in y) with noise of 0.05, zero on the clamped
    face x = 0."""
    rng = np.random.default_rng(seed)
    x, y, z = np.meshgrid(*(np.linspace(0.0, 1.0, n) for n in nn),
                          indexing="ij")
    u = np.stack([
        -0.3 * x * (z - 0.5),
        0.1 * x * x * (y - 0.5) * (z - 0.5),
        -x * x * (3.0 - x),
    ], axis=-1)
    u += 0.05 * rng.standard_normal(u.shape)
    u[0] = 0.0
    return u.astype(np.float32)


def _jax_config():
    jcfg = JaxConfig(**ARGS, dtype="float32")
    jcfg.validate()
    return jcfg


def jax_tail(jcfg, u, *, pallas=False):
    """The JAX fused step's tail of iteration 1 from its init state and u,
    as its `tail_head` and `tail_rest` compute it (one jitted program), with
    the stages of the port's `tail_stages`.  pallas=True takes K2 from the
    TPU route's `make_pallas_quadform` in interpret mode."""
    from functools import partial

    import jax
    import jax.numpy as jnp

    from topopt_in_petsc_tpu.grid import Grid as JaxGrid
    from topopt_in_petsc_tpu.models.elasticity import LinearElasticity
    from topopt_in_petsc_tpu.ops.hex_operator import (
        element_quadratic_form as jax_quadratic_form,
    )
    from topopt_in_petsc_tpu.ops.pallas_hex import make_pallas_quadform
    from topopt_in_petsc_tpu.opt.filters import DesignFilter
    from topopt_in_petsc_tpu.opt.mma import MMA

    jax.config.update("jax_enable_x64", True)
    cfg = jcfg
    grid = JaxGrid.from_config(cfg)
    physics = LinearElasticity(cfg, grid)
    if pallas:
        physics._pallas_quadform = make_pallas_quadform(
            grid.nn, np.asarray(physics.KE), interpret=True)
    filt = DesignFilter(cfg, grid)
    mma = MMA(grid.nelem, cfg.m, grid.ne, cfg.jnp_dtype,
              precise_dots=cfg.precise_dots)
    dt = cfg.jnp_dtype
    eta = jnp.asarray(cfg.eta, dt)
    beta = jnp.asarray(cfg.beta, dt)
    projection = bool(cfg.projectionFilter)
    fc = (filt.Hs, filt._fft_consts)
    x0 = jnp.full(grid.ne, cfg.volfrac, dtype=dt)
    xt0, xp0 = jax.jit(partial(filt._project_impl, projection=projection))(
        x0, beta, eta, *fc)
    span = cfg.Xmax - cfg.Xmin

    def tail(x, xTilde, xPhys, u, L, U, fc):
        Hs, fft_consts = fc
        uKu = (physics._pallas_quadform(u) if pallas
               else jax_quadratic_form(u, physics.KE))
        fx, gx, dfdx, dgdx = physics._objective_parts(
            xPhys.astype(physics.dtype), u)
        fscale = (10.0 / fx).astype(dt)
        dfdx_raw = dfdx * fscale
        dfdx, dgdx = filt._gradients_impl(
            x, xTilde, dfdx_raw, dgdx, beta, eta, Hs, fft_consts,
            projection=projection)
        xmin, xmax = mma._movelimit_impl(
            x, jnp.asarray(cfg.Xmin, dt), jnp.asarray(cfg.Xmax, dt),
            jnp.asarray(cfg.movlim, dt))
        x_new, L, U, lam, _, _ = mma._update_impl(
            x, dfdx, gx, dgdx, xmin, xmax, L, U, x, x,
            fresh_asymptotes=True)
        xTilde, xPhys = filt._project_impl(
            x_new, beta, eta, Hs, fft_consts, projection=projection)
        return {
            "uKu": uKu, "fx": fx, "gx": gx[0], "dfdx_raw": dfdx_raw,
            "dfdx": dfdx, "dgdx": dgdx[0], "xmin": xmin, "xmax": xmax,
            "L": L, "U": U, "lam": lam, "x": x_new,
            "ch": jnp.max(jnp.abs(x_new - x)), "xTilde": xTilde,
            "xPhys": xPhys, "mnd": jnp.mean(4.0 * xPhys * (1.0 - xPhys)),
        }

    out = jax.jit(tail)(x0, xt0, xp0, jnp.asarray(u, dt),
                        x0 - 0.5 * span, x0 + 0.5 * span, fc)
    return {k: np.asarray(v) for k, v in out.items()}


def port_tail(cfg, u, gx=None):
    """The port's tail (`tail_stages`) on the CPU, as numpy arrays; with
    `gx`, the objective hands that gx[0] to the MMA update in place of the
    port's own."""
    step, _ = make_fused_step(cfg, device="cpu")
    if gx is not None:
        parts = step.physics._objective_parts

        def with_gx(xPhys, u):
            fx, g, dfdx, dgdx = parts(xPhys, u)
            g = g.clone()
            g[0] = float(gx)
            return fx, g, dfdx, dgdx

        step.physics._objective_parts = with_gx
    return {k: v.numpy() for k, v in _probe().tail_stages(step, u).items()}


def _summary_points(shape, seed=SEED):
    """The fixed sample indices and the weights of the weighted sum."""
    rng = np.random.default_rng(seed + 1)
    n = int(np.prod(shape))
    idx = np.sort(rng.choice(n, size=min(N_SAMPLE, n), replace=False))
    return idx, rng.uniform(-1.0, 1.0, size=n)


def summarize(tail):
    """{stage.part: array}: each field at the sample points (f32), its
    largest magnitude, l1 norm, sum and weighted sum (f64); each scalar."""
    idx, w = _summary_points(tail["x"].shape)
    out = {}
    for k in FIELDS:
        v = np.asarray(tail[k], np.float64).ravel()
        out.update({f"{k}.samples": v[idx].astype(np.float32),
                    f"{k}.max": np.abs(v).max(),
                    f"{k}.l1": np.abs(v).sum(), f"{k}.sum": v.sum(),
                    f"{k}.wsum": (v * w).sum()})
    for k in SCALARS:
        out[k] = np.asarray(tail[k], np.float64).ravel()[0]
    return out


def _digest():
    fields = dataclasses.asdict(_jax_config())
    return input_digest(
        "campaign-tail", sorted((k, v) for k, v in fields.items()
                                if k != "workdir"),
        seeded_u(NN), SEED, N_SAMPLE, FIELDS, SCALARS)


def _field_errors(got, ref):
    """(samples, sum, weighted sum) errors of a summarized field against
    another, each relative as the bars are (absolute for a field of
    zeros)."""
    rel = lambda d, scale: d / scale if scale > 0 else d  # noqa: E731
    diff = np.abs(got["samples"].astype(np.float64) - ref["samples"]).max()
    return (rel(diff, ref["max"]),
            rel(abs(got["sum"] - ref["sum"]), ref["l1"]),
            rel(abs(got["wsum"] - ref["wsum"]), ref["l1"]))


def _part(summary, k):
    pre = f"{k}."
    return {n[len(pre):]: summary[n] for n in summary if n.startswith(pre)}


def _scalar_error(got, ref, k):
    kind, bar = SCALAR_BARS[k]
    return abs(got - ref) / (abs(ref) if kind == "rel" else 1.0), bar


@pytest.fixture(scope="module")
def tails():
    """{JAX route: summary}, and the port's summaries by the gx[0] its MMA
    update takes: its own ("port") and the JAX one ("jax_gx")."""
    jax_runs = {r: load(SNAPSHOT, r, _digest(), WRITER)
                for r in ("xla", "pallas")}
    cfg = TopOptConfig(**ARGS, device="cpu")
    u = seeded_u(NN)
    port = {"port": summarize(port_tail(cfg, u)),
            "jax_gx": summarize(port_tail(cfg, u, gx=jax_runs["xla"]["gx"]))}
    return jax_runs, port


def test_the_grid_has_the_campaigns_filter_kernel():
    """rmin/h and the 41³ box of the campaign's 257³ -rmin 0.08."""
    kernels = []
    for args in (ARGS, dict(nx=257, ny=257, nz=257, nlvls=5, rmin=0.08)):
        g = Grid.from_config(TopOptConfig(**args, device="cpu"))
        kernels.append((tuple(round(args["rmin"] / h, 6) for h in g.h),
                        filter_stencil_halfwidth(args["rmin"], g.h, g.nn)))
    assert kernels[0] == kernels[1] == ((10.24, 20.48, 20.48), 20)


@pytest.mark.parametrize("stage", FIELDS)
def test_tail_field_matches_jax(tails, stage):
    jax_runs, port = tails
    errs = _field_errors(_part(port["port"], stage),
                         _part(jax_runs["xla"], stage))
    assert max(errs) <= FIELD_BAR, (stage, errs)


@pytest.mark.parametrize("stage", ["fx", "gx"])
def test_tail_scalar_matches_jax(tails, stage):
    jax_runs, port = tails
    got, ref = float(port["port"][stage]), float(jax_runs["xla"][stage])
    err, bar = _scalar_error(got, ref, stage)
    assert err <= bar, (stage, got, ref, err)


def test_pre_loop_filter_keeps_the_volume():
    """The port's pre-loop density filter (FFT route) of the uniform design
    keeps its mean to f32 rounding: within 1e-8 of volfrac in f32."""
    cfg = TopOptConfig(**ARGS, device="cpu")
    step, state = make_fused_step(cfg)
    assert step.filt._fft_conv is not None
    exact = float(np.float32(cfg.volfrac)) - cfg.volfrac
    mean = float(state.xPhys.double().mean()) - cfg.volfrac
    assert abs(mean - exact) <= 1e-8, (mean, exact)


@pytest.mark.parametrize("stage", MMA_STAGES)
def test_mma_update_matches_jax_at_its_volume(tails, stage):
    jax_runs, port = tails
    got = port["jax_gx"]
    if stage in SCALAR_BARS:
        err, bar = _scalar_error(float(got[stage]),
                                 float(jax_runs["xla"][stage]), stage)
        assert err <= bar, (stage, err)
    else:
        errs = _field_errors(_part(got, stage), _part(jax_runs["xla"], stage))
        assert max(errs) <= FIELD_BAR, (stage, errs)


def test_k2_matches_the_jax_pallas_kernel(tails):
    """K2's plain twin against the TPU route's Pallas kernel (interpret
    mode), and that kernel against the JAX CPU route."""
    jax_runs, port = tails
    pal = _part(jax_runs["pallas"], "uKu")
    assert max(_field_errors(_part(port["port"], "uKu"), pal)) <= FIELD_BAR
    assert max(_field_errors(pal, _part(jax_runs["xla"], "uKu"))) \
        <= FIELD_BAR


def test_tail_stages_are_the_fused_steps_iteration():
    """`tail_stages` from the state field of the fused step's first
    iteration gives that iteration's design, asymptotes and scalars bit
    for bit (33x17x17, `-rmin 0.3`: a 9³ box, the FFT route)."""
    cfg = TopOptConfig(nx=33, ny=17, nz=17, nlvls=3, rmin=0.3, fused=True,
                       device="cpu")
    step, state = make_fused_step(cfg)
    assert step.filt._fft_conv is not None
    step(state, 1)
    stages = _probe().tail_stages(step, state.u.clone())
    for k in ("x", "xTilde", "xPhys", "L", "U", "fx", "ch", "mnd"):
        assert torch.equal(stages[k], getattr(state, k)), k


def test_probe_tail_devices_lines(tmp_path, capsys):
    """`--tail-devices` after a `-maxItr 1` run: one line per stage of the
    tail on one device against the other (here the CPU twice, exactly
    equal) and the tail's design against the run's restart (equal: the
    tail is the run's iteration)."""
    cli = ["-device", "cpu", "-nx", "33", "-ny", "17", "-nz", "17",
           "-nlvls", "3", "-rmin", "0.3", "-fused", "1", "-maxItr", "1",
           "-output_cadence_vtu", "0", "-workdir", str(tmp_path)]
    probe = _probe()
    assert probe.main(cli) == 0
    capsys.readouterr()
    assert probe.tail_devices(cli, ("cpu", "cpu")) == 0
    lines = capsys.readouterr().err.splitlines()
    tail = [ln for ln in lines if ln.startswith("# tail ")]
    assert len(tail) == len(FIELDS) + len(SCALARS) + 4
    assert all(" 0.000e+00" in ln for ln in tail), tail


def _uku_f64(u, KE, slab=16):
    """uᵀKEu per element in f64 from the f32 u and KE, by x-slabs."""
    u64 = torch.from_numpy(np.asarray(u, np.float64))
    KE64 = torch.as_tensor(np.asarray(KE, np.float32), dtype=torch.float64)
    ex = u64.shape[0] - 1
    return torch.cat([element_quadratic_form(u64[i:min(i + slab, ex) + 1],
                                             KE64)
                      for i in range(0, ex, slab)]).numpy()


def compare_stages(run_dir, cli):
    """Both tails from the state field of the JAX run in `run_dir`, stage
    by stage, and the port's again with the JAX gx[0]; K2 also against uKu
    in f64.  Prints one line per stage and returns {stage: errors}."""
    from topopt_in_petsc_tpu_torch.models.elements import hex8_stiffness

    with np.load(os.path.join(run_dir, "RestartSol00.npz")) as z:
        u = z["u"]
    with np.load(os.path.join(run_dir, "Restart00.npz")) as z:
        run = {k: z[k] for k in ("x", "xPhys", "L", "U")}
        assert int(z["itr"]) == 1, "the stages are iteration 1's"
    jcfg = JaxConfig.from_args(cli)
    jcfg.validate()
    cfg = TopOptConfig.from_args([*cli, "-device", "cpu"])
    ref = jax_tail(jcfg, u)
    pal = jax_tail(jcfg, u, pallas=True)
    port = port_tail(cfg, u)
    port_gx = port_tail(cfg, u, gx=ref["gx"])
    err = _probe().field_error
    exact = _uku_f64(u, hex8_stiffness(*Grid.from_config(cfg).h, cfg.nu))
    print("uKu against f64: " + ", ".join(
        f"{name} {err(v, exact):.3e}" for name, v in (
            ("JAX", ref["uKu"]), ("JAX Pallas", pal["uKu"]),
            ("port", port["uKu"]))))
    print(f"gx[0]: JAX {float(ref['gx']):.6e}, port {float(port['gx']):.6e}")
    out = {}
    print(f"{'stage':10s} {'port/JAX':>10s} {'port,JAXgx':>10s} "
          f"{'Pallas/JAX':>10s} {'JAX/run':>10s}  JAX value (largest "
          "magnitude)")
    for k in ref:
        out[k] = errs = (err(port[k], ref[k]), err(port_gx[k], ref[k]),
                         err(pal[k], ref[k]),
                         err(ref[k], run[k]) if k in run else None)
        print(f"{k:10s} " + " ".join(
            f"{'' if e is None else f'{e:.3e}':>10s}" for e in errs)
            + f"  {float(np.abs(ref[k]).max()):.9g}", flush=True)
    return out


if __name__ == "__main__":
    import jax

    jax.config.update("jax_enable_x64", True)
    if sys.argv[1:2] == ["--stages"]:
        compare_stages(sys.argv[2], sys.argv[3:])
        sys.exit(0)
    # write the JAX tails that the tests read
    u = seeded_u(NN)
    runs = {route: (_digest(),
                    summarize(jax_tail(_jax_config(), u,
                                       pallas=route == "pallas")))
            for route in ("xla", "pallas")}
    save(SNAPSHOT, runs)
    print(f"wrote {SNAPSHOT}: {sorted(runs)}")
