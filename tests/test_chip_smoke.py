"""chip_smoke.py without a GPU: it must stop at phase 0, print no result,
and exit non-zero — never carry on on the CPU."""

import json
import pathlib
import subprocess
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]


def test_phase0_refuses_cpu_backend():
    sys.path.insert(0, str(ROOT))
    try:
        import chip_smoke
    finally:
        sys.path.remove(str(ROOT))
    with pytest.raises(SystemExit, match="no GPU"):
        chip_smoke.phase_device()


def test_script_exits_nonzero_without_gpu():
    out = subprocess.run(
        [sys.executable, str(ROOT / "chip_smoke.py"), "--only", "0"],
        capture_output=True, text=True, timeout=300,
        env={"JAX_PLATFORMS": "cpu", "PATH": "/usr/bin:/bin",
             "HOME": str(ROOT)})
    assert out.returncode != 0
    assert "no GPU" in out.stderr
    last = out.stdout.strip().splitlines()[-1:] or [""]
    with pytest.raises(json.JSONDecodeError):
        json.loads(last[0])
