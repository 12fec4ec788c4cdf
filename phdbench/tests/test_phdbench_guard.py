"""The run refuses to report when JAX or the JAX package was loaded
(top-level names compared whole), and without a card."""

import json
import os
import subprocess
import sys
import types
from pathlib import Path

import pytest

from phdbench import harness, run

ROOT = Path(__file__).resolve().parents[2]


def test_forbidden_names_compared_whole(monkeypatch):
    monkeypatch.delitem(sys.modules, "jax", raising=False)
    assert not [m for m in harness.forbidden_modules()
                if m.startswith("phdslam_tpu_torch")]
    monkeypatch.setitem(sys.modules, "phdslam_tpu.filters",
                        types.ModuleType("phdslam_tpu.filters"))
    monkeypatch.setitem(sys.modules, "jaxlib", types.ModuleType("jaxlib"))
    found = harness.forbidden_modules()
    assert "phdslam_tpu.filters" in found and "jaxlib" in found


def test_run_fails_when_jax_was_loaded(monkeypatch, capsys):
    result = {"correct": True, "attempted": 1, "failed": 0, "metrics": {},
              "device": {}, "check": {"pose_m": {"value": 0, "limit": 1}}}
    monkeypatch.setattr(harness, "run", lambda *a, **k: result)
    monkeypatch.setitem(sys.modules, "jax", types.ModuleType("jax"))
    rc = run.main(["--workload", "dense-phd.replay", "--seed", "1",
                   "--seconds", "1"])
    out = capsys.readouterr()
    assert rc == 3 and out.out.strip() == ""
    assert "jax" in out.err
    monkeypatch.delitem(sys.modules, "jax")
    assert run.main(["--workload", "dense-phd.replay", "--seed", "1",
                     "--seconds", "1"]) == 0
    last = capsys.readouterr().out.strip().splitlines()[-1]
    assert list(json.loads(last))[-1] == "check"


def test_no_card_no_result():
    import torch
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    p = subprocess.run([sys.executable, "phdbench/run.py", "--workload",
                        "dense-phd.replay", "--seed", "1", "--seconds", "1"],
                       cwd=ROOT, capture_output=True, text=True, env=env,
                       timeout=120)
    assert p.returncode == 2 and p.stdout.strip() == ""


def test_harness_imports_no_jax():
    code = ("import sys; sys.path.insert(0, %r); "
            "import phdbench.harness, phdbench.reference.compare, "
            "phdbench.reference.cphd, "
            "phdslam_tpu_torch.slam; "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'flax', 'phdslam_tpu')]; "
            "print(bad); sys.exit(1 if bad else 0)") % str(ROOT)
    p = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=120)
    assert p.returncode == 0, p.stdout + p.stderr
