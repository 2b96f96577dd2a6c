"""The comparison has to fail what it must: the control (the reference
computed in bfloat16 in the program's place) on every cell, and, with
the look for a card skipped, whole runs whose timed path is broken
underneath: a step that returns its state unchanged, half of the
elements' energies left out and the rest doubled, the design update
altered where MMA makes it, and the state solve's answer altered.  One
card holds each cell, so no exchange between chips can be left out."""

import pytest
import torch

from perfbench import harness
from perfbench.tests.conftest import small

CELLS = ["c257.fused", "c257.pde", "c257.bf16"]
SEED = 2 ** 31 + 33


def _run(cell, **kw):
    return harness.run_cell(small(harness.cell_spec(cell)), SEED, 0.5,
                            False, device="cpu", **kw)


@pytest.mark.parametrize("cell", CELLS)
def test_the_control_is_not_correct(cell):
    r = _run(cell, control=True)
    assert not r["correct"]
    over = [k for k, v in r["compared"].items() if v["value"] > v["limit"]]
    assert {"compliance_gap", "mma_gap"} <= set(over)


def _half_energies(quadform):
    def broken(u, KE):
        q = quadform(u, KE)
        half = q.shape[0] // 2
        return torch.cat([2.0 * q[:half], torch.zeros_like(q[half:])])
    return broken


def _altered_x(dip_x):
    def broken(self, d, sub):
        x = dip_x(self, d, sub).clone()
        x.view(-1)[0] += 0.01
        return x
    return broken


def _altered_u(solution):
    def broken(self, x):
        u = solution(self, x).clone()
        u[-1, -1, -1] *= 2.0  # the far loaded corner's displacement
        return u
    return broken


def _faults():
    from topopt_in_petsc_tpu_torch.models import elasticity
    from topopt_in_petsc_tpu_torch.opt.mma import MMA
    from topopt_in_petsc_tpu_torch.parallel.fused_step import FusedStep

    return {
        "unchanged": (FusedStep, "__call__", lambda self, s, itr=3: s),
        "half": (elasticity, "quadform",
                 _half_energies(elasticity.quadform)),
        "x": (MMA, "dip_x", _altered_x(MMA.dip_x)),
        "u": (elasticity.LinearElasticity, "solution",
              _altered_u(elasticity.LinearElasticity.solution)),
    }


@pytest.mark.parametrize("fault", ["unchanged", "half", "x", "u"])
def test_a_broken_path_is_not_correct(fault, monkeypatch):
    owner, name, broken = _faults()[fault]
    monkeypatch.setattr(owner, name, broken)
    r = _run("c257.fused")
    assert not r["correct"], (fault, r["compared"])
