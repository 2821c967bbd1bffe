"""Which tier runs where, that interpret mode is only ever asked for, and
where the compile cache lives."""

import os
import subprocess
import sys

import numpy as np
import pytest
import jax
import jax.numpy as jnp

import pathtracer_tpu
from pathtracer_tpu import integrator
from pathtracer_tpu.ops import spheres
from pathtracer_tpu.ops.pallas import sphere_kernel as sk

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("platform,want", [("cpu", "xla"), ("gpu", "triton"),
                                           ("other", "xla")])
def test_default_backend_from_platform(platform, want, monkeypatch):
    monkeypatch.setattr(jax, "default_backend", lambda: platform)
    assert integrator.default_backend() == want
    assert integrator.resolve_backend(None) == want
    from pathtracer_tpu.models import cornell
    from pathtracer_tpu.ppm import PPMRenderer

    scene, cam, lights = cornell.build(1.0)
    r = PPMRenderer(scene, cam, lights, 8, 8, verbose=False)
    assert r.backend == want and r.interpret is False


@pytest.mark.parametrize("name", ["pallas", "pallas2", "pallas_interpret",
                                  "pallas2_interpret"])
def test_removed_backend_names_are_refused(name):
    with pytest.raises(ValueError):
        integrator.resolve_backend(name)


@pytest.mark.parametrize("platform", ["cpu", "gpu"])
def test_interpret_never_chosen_from_platform(platform, monkeypatch):
    """The kernel tier asks for interpret mode only when the caller does."""
    from pathtracer_tpu.models import shirley

    seen = []

    def fake_kernel(table, org, d, alive, interpret=False, **kw):
        seen.append(interpret)
        return spheres.intersect_packed(
            table[0], table[1], table[2], table[3], None, table[4] > 0,
            org, d)

    monkeypatch.setattr(jax, "default_backend", lambda: platform)
    monkeypatch.setattr(sk, "intersect_spheres", fake_kernel)
    scene, cam, _ = shirley.build(1.0)
    org = jnp.zeros((4, 3))
    d = jnp.tile(jnp.asarray([[0.0, 0.0, 1.0]]), (4, 1))
    integrator.make_intersector(scene, None)(org, d, jnp.ones(4, bool))
    integrator.make_intersector(scene, "triton")(org, d, jnp.ones(4, bool))
    integrator.make_intersector(scene, "triton", interpret=True)(
        org, d, jnp.ones(4, bool))
    want = [False, True] if platform == "cpu" else [False, False, True]
    assert seen == want


@pytest.mark.parametrize("backend,tiled", [("xla", False), ("triton", True)])
def test_tiled_ray_order_follows_the_tier(backend, tiled):
    from pathtracer_tpu.models import shirley

    _, cam, bg = shirley.build(2.0)
    pass_fn = integrator.make_pass_fn(cam, bg, 40, 20, 1, 2, backend=backend)
    assert hasattr(pass_fn, "untile") == tiled


@pytest.mark.parametrize("env_set", [True, False])
def test_compile_cache_dir(env_set, tmp_path):
    """JAX_COMPILATION_CACHE_DIR wins and nothing else is set in code;
    otherwise the cache is one fixed git-ignored directory in the
    checkout."""
    env = {k: v for k, v in os.environ.items()
           if k != pathtracer_tpu.CACHE_ENV}
    if env_set:
        env[pathtracer_tpu.CACHE_ENV] = str(tmp_path)
        want = str(tmp_path)
    else:
        want = os.path.join(ROOT, ".jax_cache")
    assert pathtracer_tpu.compilation_cache_dir(env) == want
    env["JAX_PLATFORMS"] = "cpu"
    out = subprocess.run(
        [sys.executable, "-c", "import pathtracer_tpu, jax; "
         "print(jax.config.jax_compilation_cache_dir)"],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=120,
        check=True).stdout.strip()
    assert out == want
    if not env_set:
        ignored = subprocess.run(["git", "check-ignore", "-q", want],
                                 cwd=ROOT).returncode
        assert ignored in (0, 128)  # ignored, or not a git checkout


def test_sphere_kernel_block_padding_matches_unpadded():
    """Ray counts off the block size are padded with dead rays and the
    padding is sliced off: results equal those of the padded call."""
    rs = np.random.RandomState(1)
    c = jnp.asarray(rs.uniform(-3, 3, (20, 3)).astype(np.float32) + [0, 0, 9])
    r = jnp.asarray(rs.uniform(0.5, 2, 20).astype(np.float32))
    table = sk.pack_spheres(c, r, jnp.ones(20, bool))
    d = rs.randn(sk.RAY_BLOCK + 5, 3).astype(np.float32) * 0.2
    d[:, 2] = 1.0
    o = np.zeros_like(d)
    full = sk.intersect_spheres(table, jnp.asarray(o), jnp.asarray(d),
                                interpret=True)
    part = sk.intersect_spheres(table, jnp.asarray(o[:-5]),
                                jnp.asarray(d[:-5]), interpret=True)
    for a, b in zip(full, part):
        np.testing.assert_array_equal(np.asarray(a)[:-5], np.asarray(b))
