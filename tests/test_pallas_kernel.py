"""Pallas-Triton sphere kernel vs the fused-XLA intersection (interpret mode
on CPU — the A/B correctness oracle in the spirit of the reference's
--no-simd)."""

import numpy as np
import pytest
import jax
import jax.numpy as jnp

from pathtracer_tpu.ops import spheres
from pathtracer_tpu.ops.pallas import sphere_kernel as sk


def _both(centers, radii, valid, org, d, alive=None, **bounds):
    packed = spheres.pack_for_intersect(jnp.asarray(centers),
                                        jnp.asarray(radii), jnp.asarray(valid))
    want = spheres.intersect_packed(*packed, jnp.asarray(valid),
                                    jnp.asarray(org), jnp.asarray(d),
                                    **bounds)
    table = sk.pack_spheres(jnp.asarray(centers), jnp.asarray(radii),
                            jnp.asarray(valid))
    got = sk.intersect_spheres(
        table, jnp.asarray(org), jnp.asarray(d),
        None if alive is None else jnp.asarray(alive), interpret=True,
        **bounds)
    return [np.asarray(x) for x in want], [np.asarray(x) for x in got]


def test_pallas_matches_xla_intersection():
    rs = np.random.RandomState(7)
    S = 64
    n = 1024
    centers = rs.uniform(-8, 8, (S, 3)).astype(np.float32)
    radii = rs.uniform(0.3, 2.0, S).astype(np.float32)
    valid = np.ones(S, bool)
    valid[S // 2] = False
    org = rs.uniform(-1, 1, (n, 3)).astype(np.float32)
    d = rs.randn(n, 3).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)

    (at_x, idx_x, hit_x, _), (at_p, idx_p, hit_p, _) = _both(
        centers, radii, valid, org, d)
    np.testing.assert_array_equal(hit_x, hit_p)
    h = hit_x
    np.testing.assert_array_equal(idx_x[h], idx_p[h])
    np.testing.assert_allclose(at_x[h], at_p[h], rtol=1e-5)


def _random_case(rs, n, s, org_scale=0.5):
    centers = rs.uniform(-6, 6, (s, 3)).astype(np.float32)
    centers[:, 2] += 12.0  # in front of the origin
    radii = rs.uniform(0.5, 2.5, s).astype(np.float32)
    org = rs.uniform(-org_scale, org_scale, (n, 3)).astype(np.float32)
    d = rs.randn(n, 3).astype(np.float32) * 0.3
    d[:, 2] = 1.0
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return centers, radii, np.ones(s, bool), org, d


def _case(name):
    rs = np.random.RandomState(sum(map(ord, name)))
    alive, bounds = None, {}
    if name == "ragged_ray_count":  # not a multiple of RAY_BLOCK
        c, r, v, o, d = _random_case(rs, 1000, 40)
    elif name == "single_sphere":
        c, r, v, o, d = _random_case(rs, 300, 1)
        r[:] = 6.0
    elif name == "shirley_531":
        from pathtracer_tpu.models import shirley

        scene, cam, _ = shirley.build(2.0)
        c = np.asarray(scene.center)
        r = np.asarray(scene.radius)
        v = np.asarray(scene.valid)
        ys, xs = np.mgrid[0:16, 0:32]
        d = np.asarray(cam.ray_dirs(jnp.asarray((xs + 0.5) / 32.0),
                                    jnp.asarray(1.0 - (ys + 0.5) / 16.0),
                                    jnp.float32)).reshape(-1, 3)
        o = np.zeros_like(d)
    elif name == "all_dead":
        c, r, v, o, d = _random_case(rs, 256, 40)
        alive = np.zeros(len(o), bool)
    elif name == "inside_dielectric":
        # rays starting inside a sphere, in every direction: the stable
        # quadratic's inside-with-b'<0 quirk (sphere.ml:44-53) rejects the
        # far wall for rays pointing away from the centre
        c = np.array([[0.0, 0.0, 0.0], [0.0, 0.0, 5.0]], np.float32)
        r = np.array([2.0, 1.0], np.float32)
        v = np.ones(2, bool)
        o = rs.uniform(-0.8, 0.8, (512, 3)).astype(np.float32)
        d = rs.randn(512, 3).astype(np.float32)
        d /= np.linalg.norm(d, axis=1, keepdims=True)
    elif name == "t_bounds":
        c, r, v, o, d = _random_case(rs, 512, 40)
        bounds = dict(t_min=11.0, t_max=14.0)
    return c, r, v, o, d, alive, bounds


@pytest.mark.parametrize("name", ["ragged_ray_count", "single_sphere",
                                  "shirley_531", "all_dead",
                                  "inside_dielectric", "t_bounds"])
def test_sphere_kernel_matches_xla(name):
    """Hit mask and winner identical; `a*t` to 1e-4 relative. Both sides
    are f32 evaluations of the same quadratic in different operation
    orders, and a grazing hit amplifies the rounding of
    disc = A + 2c.o - |o|^2 + b'^2 by 1/sqrt(disc) (up to ~5e-5 here)."""
    c, r, v, o, d, alive, bounds = _case(name)
    (at_x, idx_x, hit_x, inv_a_x), (at_p, idx_p, hit_p, inv_a_p) = _both(
        c, r, v, o, d, alive, **bounds)
    assert at_p.shape == (len(o),) and idx_p.dtype == np.int32
    want_hit = hit_x if alive is None else hit_x & alive
    np.testing.assert_array_equal(hit_p, want_hit)
    if name == "all_dead":
        assert not hit_p.any()
        return
    assert want_hit.any()
    h = want_hit
    np.testing.assert_array_equal(idx_p[h], idx_x[h])
    np.testing.assert_allclose(at_p[h], at_x[h], rtol=1e-4)
    np.testing.assert_allclose(inv_a_p, inv_a_x, rtol=3e-7)  # 1-2 ulp
    if name == "inside_dielectric":
        # some rays leave the inner sphere through its wall, others are
        # rejected by the quirk and escape to the far sphere or nothing
        assert (idx_p[h] == 0).any() and (~h).any()


def test_sphere_kernel_pads_to_chunk():
    table = sk.pack_spheres(jnp.ones((33, 3)), jnp.ones(33), jnp.ones(33, bool))
    assert table.shape == (5, -(-33 // sk.SPH_CHUNK) * sk.SPH_CHUNK)
    np.testing.assert_array_equal(np.asarray(table[4, 33:]), 0.0)


@pytest.mark.gpu
def test_sphere_kernel_compiled_on_gpu():
    """The kernel as compiled for the card (no interpret mode)."""
    if jax.devices()[0].platform != "gpu":
        pytest.skip("needs a GPU: the compiled Triton kernel has no CPU "
                    "backend")
    c, r, v, o, d, alive, bounds = _case("shirley_531")
    packed = spheres.pack_for_intersect(jnp.asarray(c), jnp.asarray(r),
                                        jnp.asarray(v))
    at_x, idx_x, hit_x, _ = spheres.intersect_packed(
        *packed, jnp.asarray(v), jnp.asarray(o), jnp.asarray(d))
    at_p, idx_p, hit_p, _ = sk.intersect_spheres(
        sk.pack_spheres(jnp.asarray(c), jnp.asarray(r), jnp.asarray(v)),
        jnp.asarray(o), jnp.asarray(d))
    np.testing.assert_array_equal(np.asarray(hit_p), np.asarray(hit_x))
