"""The port's CLAP checkpoint -> ``cli score`` -> CLAP/KAD parity drill at the
full ``laion/clap-htsat-fused`` geometry (``audioldm_tpu_torch/tools/
eval_drill.py``, a subprocess; the port's counterpart of
tests/test_eval_drill.py): a transformers ``ClapModel`` with random bias
tables and BatchNorm statistics written as an HF directory, two corpora of
48 kHz wavs, ``python -m audioldm_tpu_torch.cli score --device cpu``, the
numbers held to transformers computed the reference's way."""

import json
import os
import subprocess
import sys

import pytest

pytestmark = pytest.mark.slow

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_full_geometry_eval_drill(tmp_path):
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    proc = subprocess.run(
        [sys.executable, "-m", "audioldm_tpu_torch.tools.eval_drill", "--width", "full", "--clips", "3",
         "--out", str(tmp_path / "drill")],
        env=env, capture_output=True, text=True, timeout=1200, cwd=REPO,
    )
    assert proc.returncode == 0, f"stdout:\n{proc.stdout}\nstderr:\n{proc.stderr}"
    result = json.loads(proc.stdout.strip().splitlines()[-1])
    assert result["pass"], result
    assert result["embed_spread"] > 1e-3 and result["bandwidth"] > 1e-6
