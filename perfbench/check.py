"""The comparison that decides a run's `correct`.

The state of one optimization iteration of the measured window, drawn
from the seed, is copied to the host before and after the iteration:
what the step reads (x, xPhys, L, U, xo1, xo2, fscale) and what it
makes (x, xPhys, u, L, U, fx).  Once the window has closed and the
program is freed, the plain float64 reference (`reference/`) follows
that step from the program's own state and judges each output:

- `solve_relres`: ||A u - f|| / ||f|| of the program's solution u for
  the supported cantilever system with the program's E(xPhys), the
  operator rebuilt from the element matrix: the state solve (K1 or
  K1-bf16 under MG-PCG);
- `energy_gap`: |f.u - sum_e E_e u_e^T KE u_e| / f.u, the compliance
  taken as the load's work and as the strain energy, equal for a solved
  u: a solve stopped short moves it at first order, the f32 rounding of
  u hardly (a residual norm reads that rounding first);
- `compliance_gap`: |fx - sum_e E_e u_e^T KE u_e| / that sum: the
  compliance (K2's element energies);
- `mma_gap`: the largest gap of the new x, L and U to one MMA update made
  from the reference's sensitivities (K2's energies through the filter's
  chain rule) with its dual solved exactly;
- `filter_gap`: the largest gap of xPhys, read and written, to the
  reference filter of x (the density filter's FFT convolution, or the
  PDE filter's solve with K3);
- `start_gap`: at the start of the run, before iteration 1, the gap of
  the loaded x to the seeded design and of xPhys to its filter.

The reference stores the element matrices as the configuration does
(float32, unless `-dtype float64`) and computes in float64 from there:
the f32 rounding of the elasticity matrix alone moves the compliance by
~3.5% at 257^3, a property of the configuration's precision that every
f32 run shares, and not what this comparison judges.

The control (`control_outputs`) puts the reference itself, computed in
bfloat16, in the program's place: the element matrix stored in
bfloat16, every stage's result rounded to bfloat16, its state solution
the program's rounded to bfloat16, the best that a solve held in
bfloat16 could give.
"""

from __future__ import annotations

import torch

from perfbench.reference import fem, mma
from perfbench.reference.elements import elasticity_ke
from perfbench.reference.filters import make_filter

F64 = torch.float64
INPUTS = ("x", "xPhys", "L", "U", "xo1", "xo2", "fscale")
OUTPUTS = ("x", "xPhys", "u", "L", "U", "fx")
NUMBERS = ("start_gap", "solve_relres", "energy_gap", "compliance_gap",
           "mma_gap", "filter_gap")


class Snapshot:
    """Host copies of some fields of the program's state, in buffers made
    once (pinned on a card)."""

    def __init__(self, state, names):
        pin = state.x.is_cuda
        self.bufs = {n: torch.empty(getattr(state, n).shape,
                                    dtype=getattr(state, n).dtype,
                                    pin_memory=pin) for n in names}

    def take(self, state) -> None:
        for n, b in self.bufs.items():
            b.copy_(getattr(state, n), non_blocking=True)
        if state.x.is_cuda:
            torch.cuda.synchronize()


STORED = {"float32": torch.float32, "float64": F64}


def _rounded(a, dtype):
    """The numpy array `a` rounded to `dtype`, as float64 numpy."""
    return torch.as_tensor(a).to(dtype).to(F64).numpy()


def _bf16(t):
    return t.to(torch.bfloat16).to(F64)


def _gap(a, b) -> float:
    return float(torch.max(torch.abs(a.to(b.device, F64) - b)))


def _rel(a: float, b: float) -> float:
    """|a - b| / |b|, infinite where b is 0 (never a sound compliance)."""
    return abs(a - b) / abs(b) if b else float("inf")


class Reference:
    """The reference of one configuration, from its flags (the merged
    flags of its file and its traffic's)."""

    def __init__(self, flags: dict, device):
        if flags.get("projectionFilter", 0):
            raise ValueError("the reference has no projection filter")
        self.dev = torch.device(device)
        self.nn = (flags["nx"], flags["ny"], flags["nz"])
        self.ne = tuple(n - 1 for n in self.nn)
        lo = (flags["xcmin"], flags["ycmin"], flags["zcmin"])
        hi = (flags["xcmax"], flags["ycmax"], flags["zcmax"])
        h = tuple((b - a) / e for a, b, e in zip(lo, hi, self.ne))
        self.p = {k: float(flags[k]) for k in (
            "penal", "Emin", "Emax", "volfrac", "movlim", "Xmin", "Xmax")}
        # the element matrices as the configuration stores them (f32,
        # unless -dtype float64), then used in float64
        stored = STORED[flags.get("dtype", "float32")]
        self.ke = _rounded(elasticity_ke(h, flags["nu"]), stored)
        self.f, self.free = fem.cantilever(self.nn, self.dev)
        self.filt = make_filter(flags["filter"], self.ne, h, flags["rmin"],
                                self.dev, kf_dtype=stored)
        self.ke_control = _rounded(self.ke, torch.bfloat16)

    def _on(self, t):
        return t.to(self.dev, F64)

    def _simp(self, xPhys):
        p = self.p
        return p["Emin"] + xPhys ** p["penal"] * (p["Emax"] - p["Emin"])

    def _mma(self, inp, u, rnd, ke):
        """The reference update from the step's inputs and the solution u,
        with the element matrix ke: (x, L, U), each through `rnd`."""
        p = self.p
        x, xPhys = self._on(inp["x"]), self._on(inp["xPhys"])
        ce = fem.energies(self._on(u), ke)
        dfdx = rnd(-p["penal"] * xPhys ** (p["penal"] - 1.0)
                   * (p["Emax"] - p["Emin"]) * ce * float(inp["fscale"]))
        gx = float(torch.mean(xPhys)) - p["volfrac"]
        dgdx = torch.full_like(x, 1.0 / x.numel())
        xmin = torch.clamp(x - p["movlim"], min=p["Xmin"])
        xmax = torch.clamp(x + p["movlim"], max=p["Xmax"])
        out = mma.update(x, rnd(self.filt.chain(dfdx)), gx,
                         rnd(self.filt.chain(dgdx)), xmin, xmax,
                         *(self._on(inp[k]) for k in ("L", "U", "xo1",
                                                      "xo2")))
        return tuple(rnd(t) for t in out)

    def judge(self, inp, out) -> dict:
        """The numbers of one step's outputs `out` from the inputs `inp`
        (both dicts of the fields INPUTS and OUTPUTS)."""
        xPhys = self._on(inp["xPhys"])
        E = self._simp(xPhys)
        u = self._on(out["u"])
        ce = fem.energies(u, self.ke)
        fx = float(torch.sum(E * ce))
        work = float(torch.sum(self.f * u))
        x, L, U = self._mma(inp, u, lambda t: t, self.ke)
        return {
            "solve_relres": fem.relres(u, E, self.ke, self.f, self.free),
            "energy_gap": _rel(fx, work),
            "compliance_gap": _rel(float(out["fx"]), fx),
            "mma_gap": max(_gap(out["x"], x), _gap(out["L"], L),
                           _gap(out["U"], U)),
            "filter_gap": max(
                _gap(inp["xPhys"], self.filt(self._on(inp["x"]))),
                _gap(out["xPhys"], self.filt(self._on(out["x"])))),
        }

    def start_gap(self, x_seed, x0, xPhys0) -> float:
        """The loaded design x0 and its filtered xPhys0 against the seeded
        design."""
        seed = self._on(torch.as_tensor(x_seed))
        return max(_gap(x0, seed), _gap(xPhys0, self.filt(seed)))

    def control_outputs(self, inp, out) -> dict:
        """The step's outputs as the reference computes them in bfloat16."""
        u = _bf16(self._on(out["u"]))
        xPhys = _bf16(self._on(inp["xPhys"]))
        E = _bf16(self._simp(xPhys))
        ke = self.ke_control
        fx = _bf16(torch.sum(E * _bf16(fem.energies(u, ke))))
        x, L, U = self._mma(inp, u, _bf16, ke)
        return {"x": x, "xPhys": _bf16(self.filt(x)), "u": u, "L": L,
                "U": U, "fx": fx}

    def control_start(self, x_seed):
        """(x0, xPhys0) of the start as the reference makes them in
        bfloat16."""
        x0 = _bf16(self._on(torch.as_tensor(x_seed)))
        return x0, _bf16(self.filt(x0))


def verdict(numbers: dict, limits: dict) -> bool:
    """Is every number finite and at most its limit?  A number without a
    limit, or a limit without a number, fails."""
    if set(numbers) != set(limits):
        return False
    return all(v == v and v <= limits[k] for k, v in numbers.items())
