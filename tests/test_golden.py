"""Golden-image regression tests: committed CPU renders (shirley in float64,
cornell PPM in float32) pin the whole pipeline's output across refactors.
Bounds are set by the f32-vs-f64 divergence measured on CPU."""

import os

import numpy as np
import pytest

_SCENES = os.path.join(os.path.dirname(__file__), "..", "scenes")


def test_shirley_matches_f64_golden():
    from pathtracer_tpu.models import shirley
    from pathtracer_tpu.integrator import make_render_fn

    g = np.load(os.path.join(_SCENES, "golden_shirley_160x80_spp4.npz"))
    scene, cam, bg = shirley.build(2.0)
    render = make_render_fn(cam, bg, 160, 80, 4, 8, backend="xla")
    img, segs = render(scene)
    rmse = float(np.sqrt(np.mean((np.asarray(img, np.float64) - g["img"]) ** 2)))
    assert rmse < 2.5e-3, rmse  # f32 vs f64 budget at spp=4
    # segment counts may differ by a handful of boundary samples
    assert abs(int(segs) - int(g["segments"])) < 100


@pytest.mark.slow
def test_shirley_fullres_matches_f64_oracle():
    """Full-resolution quality gate (~60 s CPU): the production-size render
    (600x300, the reference README's canonical dimensions) at spp=8 must
    stay inside the f32-vs-f64 RMSE budget. Guards the fused/composite
    paths' fp-ordering margin at scale — the small goldens above can't see
    reduction-order regressions that only accumulate over full-size tiles.
    Deselect with -m 'not slow'."""
    from pathtracer_tpu.models import shirley
    from pathtracer_tpu.integrator import make_render_fn

    g = np.load(os.path.join(_SCENES, "oracle_shirley_600x300_spp8_f64.npz"))
    scene, cam, bg = shirley.build(2.0)
    render = make_render_fn(cam, bg, 600, 300, 8, 8, backend="xla")
    img, segs = render(scene)
    rmse = float(np.sqrt(np.mean(
        (np.asarray(img, np.float64) - g["img"]) ** 2)))
    # spp=8 carries ~2x the MC noise sensitivity of spp=32 (budget 1e-3),
    # so the budget here is 1.6e-3
    assert rmse < 1.6e-3, rmse
    assert abs(int(segs) - int(g["segments"])) < 200


@pytest.mark.slow
def test_shirley_northstar_config_rmse_budget():
    """The quality gate as CI: the canonical config (600x300 spp=32 b=8 —
    the reference README's command) must stay inside the 1e-3 RMSE budget
    vs the committed CPU float64 oracle (chip_smoke.py holds the GPU
    render to the same budget). ~4x the spp8 test's cost; deselect with
    -m 'not slow'."""
    from pathtracer_tpu.models import shirley
    from pathtracer_tpu.integrator import make_render_fn

    g = np.load(os.path.join(_SCENES, "oracle_shirley_600x300_spp32_f64.npz"))
    scene, cam, bg = shirley.build(2.0)
    render = make_render_fn(cam, bg, 600, 300, 32, 8, backend="xla")
    img, _segs = render(scene)
    rmse = float(np.sqrt(np.mean(
        (np.asarray(img, np.float64) - g["img"]) ** 2)))
    assert rmse < 1e-3, rmse


def test_cornell_ppm_matches_golden():
    from pathtracer_tpu.models import cornell
    from pathtracer_tpu.ppm import PPMRenderer

    g = np.load(os.path.join(_SCENES, "golden_cornell_48x48_1iter.npz"))
    scene, cam, lights = cornell.build(1.0)
    rend = PPMRenderer(scene, cam, lights, 48, 48, iterations=1,
                       photon_count=1200, max_bounces=3, verbose=False)
    img = rend.render()
    np.testing.assert_allclose(img, g["img"], rtol=1e-5, atol=1e-7)
