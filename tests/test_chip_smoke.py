"""chip_smoke.py on a machine without a GPU: it must fail, print no
result, and keep its contract's shape (the phases themselves run on the
card)."""

import json
import os
import shutil
import subprocess
import sys
from types import SimpleNamespace

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402  (importing starts nothing)


def _run(script, cwd):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("PYTHONPATH", None)
    return subprocess.run([sys.executable, script], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


def test_exits_nonzero_without_gpu():
    out = _run(os.path.join(ROOT, "chip_smoke.py"), ROOT)
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout
    assert "needs an NVIDIA GPU" in out.stderr


def test_exits_nonzero_alone_in_a_directory(tmp_path):
    shutil.copy(os.path.join(ROOT, "chip_smoke.py"), tmp_path)
    out = _run(str(tmp_path / "chip_smoke.py"), str(tmp_path))
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout


def test_main_in_process_refuses_cpu(capsys):
    assert chip_smoke.main([]) == 2
    assert capsys.readouterr().out == ""


def test_result_line_format():
    devs = [SimpleNamespace(platform="gpu",
                            device_kind="NVIDIA H100 80GB HBM3")] * 4
    line = chip_smoke.result_line(devs)
    assert json.loads(line) == {"ok": True, "device": {
        "platform": "gpu", "kind": "NVIDIA H100 80GB HBM3", "count": 4}}
    assert "\n" not in line


@pytest.mark.parametrize("argv,phases", [
    ([], chip_smoke.PHASES),
    (["--four"], ("device", "four")),
])
def test_phase_selection(argv, phases):
    """--four runs only its own phase (after the device check); the
    default run covers the whole one-GPU path and never the four-GPU
    phase."""
    assert chip_smoke.phases_for(chip_smoke.parse_args(argv)) == phases
    if not argv:
        assert "four" not in phases
        assert phases[0] == "device" and "serve" in phases


def test_every_phase_has_a_function():
    for name in chip_smoke.PHASES + chip_smoke.FOUR_PHASES:
        assert callable(getattr(chip_smoke, f"phase_{name}"))


def test_report_fails_beyond_tolerance():
    chip_smoke._report("x", 1e-4, 1e-3)
    with pytest.raises(chip_smoke.SmokeFailure):
        chip_smoke._report("x", 2e-3, 1e-3)
