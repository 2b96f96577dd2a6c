"""Nothing the benchmark loads is JAX or the JAX package, compared by the
whole top-level name of each module (the port's name begins with the JAX
package's)."""

import json
import subprocess
import sys

from perfbench import harness
from perfbench.tests.conftest import ROOT

PROBE = """
import json, sys
sys.path.insert(0, {root!r})
from perfbench import check, design, harness, roofline, tracing
from perfbench.reference import elements, fem, filters, mma
from perfbench.tests.conftest import small
for m in json.load(open({bench!r}))["per_layer"]:
    harness.load_reader(m["name"])
spec = small(harness.cell_spec("c257.pde"))
r = harness.run_cell(spec, 11, 0.2, False, device="cpu")
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""


def test_top_level_names_are_compared_whole():
    assert harness.jax_modules(["topopt_in_petsc_tpu_torch.ops.roofline",
                                "jaxtyping", "flaxen", "numpy"]) == []
    assert harness.jax_modules(["jax.numpy", "topopt_in_petsc_tpu.config",
                                "jaxlib", "flax.linen"]) == [
        "flax", "jax", "jaxlib", "topopt_in_petsc_tpu"]


def test_a_run_loads_no_jax():
    code = PROBE.format(root=str(ROOT), bench=str(ROOT / "BENCHMARK.json"))
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300,
                         env={"PATH": "/usr/bin:/bin", "HOME": "/tmp",
                              "JAX_PLATFORMS": "cpu"})
    assert out.returncode == 0, out.stderr[-2000:]
    loaded = set(json.loads(out.stdout.strip().splitlines()[-1]))
    assert "topopt_in_petsc_tpu_torch" in loaded
    assert not loaded & set(harness.JAX_NAMES), loaded


def test_the_reference_imports_nothing_of_the_program():
    for path in (ROOT / "perfbench" / "reference").glob("*.py"):
        text = path.read_text()
        assert "topopt_in_petsc_tpu" not in text, path
        assert "import jax" not in text, path
