"""What the benchmark loads: neither jax, jaxlib, flax nor the JAX package
lsm_tpu, by whole top-level name (lsm_tpu_torch, the program, begins with
lsm_tpu), and the plain reference loads nothing of the program either.
Each import runs in a fresh interpreter."""

import json
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[2]
JAX_STACK = {"jax", "jaxlib", "flax", "lsm_tpu"}


def loaded_top_levels(code: str) -> set:
    script = (f"import sys; sys.path.insert(0, {str(REPO)!r}); {code}; import json; "
              "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))")
    out = subprocess.run([sys.executable, "-c", script], capture_output=True, text=True,
                         timeout=300, cwd=REPO, env={"PATH": "/usr/bin:/bin", "JAX_PLATFORMS": "cpu"})
    assert out.returncode == 0, out.stderr
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_the_harness_loads_no_jax():
    code = ("import benchmark.run as r, benchmark.loops.port, benchmark.loops.batch, "
            "benchmark.loops.serve, benchmark.lib.roofline, benchmark.reference.controls")
    mods = loaded_top_levels(code)
    assert "lsm_tpu_torch" in mods
    assert not mods & JAX_STACK


def test_the_reference_loads_neither_jax_nor_the_program():
    mods = loaded_top_levels("import benchmark.reference.engines, benchmark.reference.controls, "
                             "benchmark.lib.check, benchmark.lib.model, benchmark.lib.corpus")
    assert not mods & (JAX_STACK | {"lsm_tpu_torch"})


@pytest.mark.parametrize("name,hit", [("lsm_tpu_torch.models", False), ("lsm_tpu.ops", True),
                                      ("jaxlib", True), ("jax_free", False)])
def test_the_run_compares_whole_top_level_names(name, hit, monkeypatch):
    from benchmark import run

    monkeypatch.setitem(sys.modules, name, object())
    assert (name in run.forbidden_modules()) == hit
