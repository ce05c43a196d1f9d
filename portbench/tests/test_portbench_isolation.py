"""What the benchmark loads: no JAX and nothing of the JAX package
(top-level module names compared whole, since the port's name begins
with the JAX package's), and a reference that loads nothing of the
port."""

import json
import subprocess
import sys

from portbench import run as pr
from portbench.tests.conftest import REPO

FORBIDDEN = {"jax", "jaxlib", "flax", "rt64tpu"}


def _top_level(modules: str):
    code = (f"import sys, json\nimport {modules}\n"
            "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, check=True,
                         capture_output=True, text=True, timeout=300).stdout
    return set(json.loads(out.strip().splitlines()[-1]))


def test_harness_loads_no_jax():
    names = _top_level("portbench.run, portbench.calibrate, portbench.program, "
                       "portbench.trace, rt64tpu_torch.api, "
                       "rt64tpu_torch.pipeline.framegraph")
    assert "rt64tpu_torch" in names and not names & FORBIDDEN


def test_reference_loads_nothing_of_the_port():
    names = _top_level("portbench.reference, portbench.shading, "
                       "portbench.check, portbench.scene, portbench.walk")
    assert not names & (FORBIDDEN | {"rt64tpu_torch"})


def test_forbidden_names_are_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "rt64tpu_torch.fake_mod", object())
    assert pr.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "rt64tpu.fake_mod", object())
    assert pr.forbidden_modules() == ["rt64tpu"]
