"""chip_smoke.py's phases at tiny sizes on the CPU (kernels in interpret
mode), its four-card phase on 4 virtual CPU devices, and its refusal to
run without a GPU."""

import os
import subprocess
import sys

import numpy as np
import pytest
import jax

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402

TEST_PLY = os.path.join(ROOT, "scenes", "test_ganesha.ply")


def _phase(name, tmp_path):
    if name == "shirley_cli":
        cs.shirley_cli(str(tmp_path), 32, 16, 1, 2)
    elif name == "shirley_oracle_kernel_tier":
        cs.shirley_oracle(os.path.join(cs.SCENES,
                                       "golden_shirley_160x80_spp4.npz"),
                          160, 80, 4, 8, limit=2.5e-3, backend="triton",
                          interpret=True)
    elif name == "cornell_cli":
        cs.ppm_cli(str(tmp_path), width=24, height=24, photons=400,
                   bounces=2, iterations=2)
    elif name == "cornell_golden":
        cs.cornell_golden(os.path.join(cs.SCENES,
                                       "golden_cornell_48x48_1iter.npz"))
    elif name == "ganesha_cli":
        cs.ppm_cli(str(tmp_path), "ganesha", width=24, height=24,
                   photons=400, bounces=2, iterations=1,
                   extra=("-ganesha-ply", TEST_PLY))
    elif name == "ganesha_pt":
        cs.ganesha_pt(TEST_PLY, 24, 24, 1, 2, backend="triton",
                      interpret=True)
    elif name == "sphere_kernel_vs_xla":
        cs.sphere_kernel_vs_xla(32, 16, interpret=True)
    elif name == "gather_kernel_vs_xla":
        cs.gather_kernel_vs_xla(32, 32, photons=1500, bounces=3,
                                interpret=True)
    elif name == "tiers_whole_image":
        cs.tiers_whole_image(TEST_PLY, 24, 24, photons=500, bounces=2,
                             interpret=True)


@pytest.mark.parametrize("name", [
    "shirley_cli", "shirley_oracle_kernel_tier", "cornell_cli",
    "cornell_golden", "ganesha_cli", "ganesha_pt", "sphere_kernel_vs_xla",
    "gather_kernel_vs_xla", "tiers_whole_image"])
def test_chip_smoke_phase_tiny(name, tmp_path, capsys):
    _phase(name, tmp_path)
    out = capsys.readouterr().out
    assert "phase=" in out and "cold_s=" in out and "warm_s=" in out


@pytest.mark.parametrize("backend", ["xla", "triton"])
def test_chip_smoke_four_card_phase_on_virtual_devices(backend, capsys):
    """The GPU run's four-card path (kernel tier) with the kernels in
    interpret mode, and the XLA tier, on 4 virtual CPU devices."""
    cs.four_cards(jax.devices()[:4], width=32, height=16, spp=4, bounces=3,
                  ppm_size=32, photons=1500, iterations=1, backend=backend,
                  interpret=backend == "triton")
    out = capsys.readouterr().out
    assert "shirley_4cards_rmse_vs_1card=" in out
    assert "cornell_4cards_ring_rmse_vs_1card=" in out
    assert "cornell_4cards_host_rmse_vs_1card=" in out


def test_chip_smoke_refuses_cpu():
    """Without a GPU the script exits non-zero and prints no ok line."""
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    res = subprocess.run([sys.executable, os.path.join(ROOT, "chip_smoke.py")],
                         cwd=ROOT, env=env, capture_output=True, text=True,
                         timeout=300)
    assert res.returncode != 0
    assert '"ok"' not in res.stdout


def test_chip_smoke_gpu_marked_tests_phase_fails_on_skips():
    """The phase that runs the `gpu` tests fails where they skip (here,
    with no GPU) instead of counting a skip as a pass."""
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    res = subprocess.run(
        [sys.executable, "-c",
         "import chip_smoke; chip_smoke.gpu_marked_tests()"],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert res.returncode != 0
    assert "a test marked gpu did not pass" in res.stderr
    assert "test_sphere_kernel_compiled_on_gpu skipped" in res.stdout


def test_chip_smoke_last_line_contract(monkeypatch, capsys, tmp_path):
    """The last stdout line is exactly the contract's JSON object."""
    class Dev:
        platform, device_kind = "gpu", "NVIDIA H100 80GB HBM3"

    monkeypatch.setattr(cs, "require_gpu", lambda count: [Dev()] * count)
    monkeypatch.setattr(cs, "card_info", lambda: "NVIDIA H100, 700.00 W")
    monkeypatch.setattr(cs, "four_cards", lambda devices: None)
    monkeypatch.setattr(cs, "OUT", str(tmp_path / "out"))
    assert cs.main(["--four-cards"]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert "NVIDIA H100, 700.00 W" in lines[-3] + lines[-2]
    import json
    assert json.loads(lines[-1]) == {"ok": True, "device": {
        "platform": "gpu", "kind": "NVIDIA H100 80GB HBM3", "count": 4}}
    np.testing.assert_equal(lines[-1].count("{"), 2)
