"""Chunk-list gather kernel (Pallas-Triton, interpret mode on CPU) and the
XLA hash gather vs a brute-force cone-filter oracle."""

import numpy as np
import pytest
import jax
import jax.numpy as jnp

from pathtracer_tpu.ops import photon_chunks as pc
from pathtracer_tpu.ops.pallas import gather_kernel as gk


def _brute_force(point, normal, active, pos, nrm, flux, valid, r):
    """O(hits x photons) reference of the cone-filter sum."""
    out = np.zeros((len(point), 3), np.float32)
    for i in range(len(point)):
        if not active[i]:
            continue
        d = pos - point[i]
        d2 = (d * d).sum(1)
        ndot = (nrm * normal[i]).sum(1)
        ok = valid & (d2 < r * r) & (ndot > 1e-3)
        w = 1.0 - np.sqrt(d2) / r
        out[i] = (flux[ok] * w[ok, None]).sum(0)
    return out


def _setup(rng, n_hits, n_pho, r):
    lo = np.zeros(3, np.float32)
    point = rng.random((n_hits, 3)).astype(np.float32)
    normal = rng.standard_normal((n_hits, 3)).astype(np.float32)
    normal /= np.linalg.norm(normal, axis=1, keepdims=True)
    active = rng.random(n_hits) < 0.9
    pos = rng.random((n_pho, 3)).astype(np.float32)
    nrm = rng.standard_normal((n_pho, 3)).astype(np.float32)
    nrm /= np.linalg.norm(nrm, axis=1, keepdims=True)
    flux = rng.random((n_pho, 3)).astype(np.float32)
    valid = rng.random(n_pho) < 0.95
    return lo, point, normal, active, pos, nrm, flux, valid


def _kernel_gather(point, normal, active, pos, nrm, flux, valid, r):
    tbl, cbox = pc.build_photon_chunks(
        jnp.asarray(pos), jnp.asarray(nrm), jnp.asarray(flux),
        jnp.asarray(valid))
    return np.asarray(gk.gather_flux(
        jnp.asarray(point), jnp.asarray(normal), jnp.asarray(active), cbox,
        tbl, np.float32(r), interpret=True))


def test_gather_kernel_matches_bruteforce():
    rng = np.random.default_rng(0)
    r = 0.06
    n_hits, n_pho = 1024, 3000
    _, point, normal, active, pos, nrm, flux, valid = _setup(
        rng, n_hits, n_pho, r)
    got = _kernel_gather(point, normal, active, pos, nrm, flux, valid, r)
    want = _brute_force(point, normal, active, pos, nrm, flux, valid, r)
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-5)
    assert (got[~active] == 0.0).all()


def test_device_side_grid_build_matches_bruteforce():
    """The renderer's kernel-tier gather (ppm.make_eye_pass with
    use_kernel): chunk map built on the device in one program, hits
    Morton-sorted into compact blocks and unsorted afterwards, must give
    the brute-force sums in the caller's hit order."""
    from pathtracer_tpu.models import cornell
    from pathtracer_tpu.ppm import make_eye_pass

    rng = np.random.default_rng(3)
    r = 0.07
    n_hits, n_pho = 1000, 2000
    _, point, normal, active, pos, nrm, flux, valid = _setup(
        rng, n_hits, n_pho, r)
    _, cam, _ = cornell.build(1.0)
    eye = make_eye_pass(cam, 8, 8, 2, n_pho, n_pho, "xla", use_kernel=True,
                        interpret=True)
    grid = pc.build_photon_chunks(jnp.asarray(pos), jnp.asarray(nrm),
                                  jnp.asarray(flux), jnp.asarray(valid))
    got = np.asarray(eye.make_gather(0)(
        jnp.asarray(point), jnp.asarray(normal), jnp.asarray(active),
        jnp.float32(r), grid))
    want = _brute_force(point, normal, active, pos, nrm, flux, valid, r)
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-5)


def test_hash_gather_dedupes_colliding_buckets():
    """Regression: two different neighbor cells hashing to the same bucket
    must not double-count its photons. With a 256-entry table collisions are
    common; the walk must still match brute force exactly."""
    from pathtracer_tpu.ppm import build_photon_grid, hash_gather

    rng = np.random.default_rng(3)
    r = 0.08
    n_pho, n_hit, m = 4000, 512, 256
    lo, point, normal, active, pos, nrm, flux, valid = _setup(
        rng, n_hit, n_pho, r)
    order, start, count = build_photon_grid(
        jnp.asarray(pos), jnp.asarray(valid), jnp.float32(r), m=m)
    grid = (order, start, count, jnp.asarray(pos), jnp.asarray(nrm),
            jnp.asarray(flux), jnp.asarray(valid))
    got = np.asarray(hash_gather(jnp.asarray(point), jnp.asarray(normal),
                                 jnp.asarray(active), jnp.float32(r), grid,
                                 grid_m=m, dep_lanes=n_pho, chunk=512))
    want = _brute_force(point, normal, active, pos, nrm, flux, valid, r)
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-5)


def test_chunk_gather_matches_bruteforce():
    """Including far outlier photons, which stretch the deposit bbox (the
    ganesha lit floor spreads deposits over thousands of units) but are
    exactly what the chunk bboxes prune."""
    rng = np.random.default_rng(0)
    r = 0.06
    n_hits, n_pho = 2048, 3000
    _, point, normal, active, pos, nrm, flux, valid = _setup(
        rng, n_hits, n_pho, r)
    pos = pos.copy()
    pos[::17] += 40.0  # sparse far outliers stretch the deposit bbox
    got = _kernel_gather(point, normal, active, pos, nrm, flux, valid, r)
    want = _brute_force(point, normal, active, pos, nrm, flux, valid, r)
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-5)
    assert (got[~active] == 0.0).all()


def test_chunk_gather_hits_near_outliers():
    """Hits placed next to the far outlier photons must still gather them
    (the chunk design has no grid boundary to fall off)."""
    rng = np.random.default_rng(2)
    r = 0.08
    n_hits, n_pho = 1024, 2000
    _, point, normal, active, pos, nrm, flux, valid = _setup(
        rng, n_hits, n_pho, r)
    pos = pos.copy()
    pos[:50] += 40.0
    point = point.copy()
    point[:100] = pos[:50].repeat(2, axis=0) + rng.standard_normal(
        (100, 3)).astype(np.float32) * (r / 4)
    got = _kernel_gather(point, normal, active, pos, nrm, flux, valid, r)
    want = _brute_force(point, normal, active, pos, nrm, flux, valid, r)
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-5)
    assert want[:100][active[:100]].sum() > 0  # oracle sees the outliers


def test_chunk_gather_no_valid_photons():
    """All-invalid deposits: every chunk bbox is inverted, no block streams
    anything, every lane returns zero."""
    rng = np.random.default_rng(4)
    r = 0.06
    _, point, normal, active, pos, nrm, flux, _ = _setup(
        rng, 1024, 500, r)
    valid = np.zeros(500, bool)
    got = _kernel_gather(point, normal, active, pos, nrm, flux, valid, r)
    assert (got == 0.0).all()


def test_gather_kernel_hit_outside_grid():
    """Eye hits far outside the deposit bbox (e.g. the lit floor's far
    reaches) must gather nothing."""
    rng = np.random.default_rng(1)
    r = 0.05
    _, point, normal, active, pos, nrm, flux, valid = _setup(
        rng, 1024, 500, r)
    point[:512] += 50.0  # far outside the unit-box photon cloud
    got = _kernel_gather(point, normal, active, pos, nrm, flux, valid, r)
    assert (got[:512] == 0.0).all()
    want = _brute_force(point, normal, active, pos, nrm, flux, valid, r)
    np.testing.assert_allclose(got[512:], want[512:], rtol=2e-4, atol=2e-5)


def test_gather_kernel_hit_one_cell_outside_edge():
    """A hit just outside the deposit bbox must still gather in-radius
    photons — the reference gathers by distance (ppm.ml:344-371), not by
    box membership; the block-vs-chunk test pads the block box by r."""
    r = 0.05
    pos = np.array([[0.01, 0.5, 0.5], [0.999, 0.5, 0.5]], np.float32)
    pos = np.repeat(pos, 4, axis=0)
    nrm = np.tile(np.array([[1.0, 0.0, 0.0]], np.float32), (8, 1))
    flux = np.ones((8, 3), np.float32)
    valid = np.ones(8, bool)
    # hits just OUTSIDE each face, within the gather radius of the photons
    point = np.zeros((1024, 3), np.float32)
    point[:, 1:] = 0.5
    point[0::2, 0] = -0.02
    point[1::2, 0] = pos[-1, 0] + 0.02
    normal = np.tile(np.array([[1.0, 0.0, 0.0]], np.float32), (1024, 1))
    active = np.ones(1024, bool)
    got = _kernel_gather(point, normal, active, pos, nrm, flux, valid, r)
    want = _brute_force(point, normal, active, pos, nrm, flux, valid, r)
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-5)
    assert want.sum() > 0  # the oracle must actually see those photons


def _gather_case(name):
    rng = np.random.default_rng(sum(map(ord, name)))
    r = 0.06
    _, point, normal, active, pos, nrm, flux, valid = _setup(
        rng, 700, 2000, r)
    if name == "empty_map":
        pos, nrm, flux = pos[:1], nrm[:1], flux[:1]
        valid = np.zeros(1, bool)
    elif name == "dense_caustic_cell":
        # a caustic: most photons inside one radius-sized cell, hits there
        pos[:1500] = 0.5 + rng.uniform(-r / 3, r / 3, (1500, 3))
        point[:200] = 0.5 + rng.uniform(-r / 2, r / 2, (200, 3))
    elif name == "hits_outside_grid":
        point[::2] -= 10.0
    elif name == "several_chunks_per_block":
        # one block's hits spread over the whole cloud: its list holds
        # most chunks
        point[:pc.HIT_BLOCK] = rng.random((pc.HIT_BLOCK, 3))
        r = 0.3
    return point, normal, active, pos, nrm, flux, valid, r


@pytest.mark.parametrize("name", ["empty_map", "dense_caustic_cell",
                                  "hits_outside_grid",
                                  "several_chunks_per_block"])
def test_gather_kernel_cases(name):
    point, normal, active, pos, nrm, flux, valid, r = _gather_case(name)
    got = _kernel_gather(point, normal, active, pos, nrm, flux, valid, r)
    want = _brute_force(point, normal, active, pos, nrm, flux, valid, r)
    assert got.shape == (len(point), 3)  # 700 hits: not a block multiple
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-5)
    if name == "empty_map":
        assert (got == 0.0).all()
    else:
        assert want.sum() > 0
    if name == "several_chunks_per_block":
        tbl, cbox = pc.build_photon_chunks(
            jnp.asarray(pos), jnp.asarray(nrm), jnp.asarray(flux),
            jnp.asarray(valid))
        _, counts = pc.block_chunk_lists(
            jnp.asarray(np.pad(point, ((0, 68), (0, 0)))),
            jnp.asarray(np.pad(active, (0, 68))), cbox, jnp.float32(r))
        assert int(counts[0]) > cbox.shape[1] // 2


def test_block_chunk_lists_are_ascending_and_complete():
    """Each block's list is the ascending set of chunks whose box meets
    the block's padded box; entries past the count are unused."""
    rng = np.random.default_rng(9)
    _, point, normal, active, pos, nrm, flux, valid = _setup(
        rng, 512, 1000, 0.05)
    _, cbox = pc.build_photon_chunks(jnp.asarray(pos), jnp.asarray(nrm),
                                     jnp.asarray(flux), jnp.asarray(valid))
    lists, counts = pc.block_chunk_lists(jnp.asarray(point),
                                         jnp.asarray(active), cbox,
                                         jnp.float32(0.05))
    lists, counts, cb = np.asarray(lists), np.asarray(counts), np.asarray(cbox)
    for b in range(len(counts)):
        pts = point[b * pc.HIT_BLOCK:(b + 1) * pc.HIT_BLOCK]
        act = active[b * pc.HIT_BLOCK:(b + 1) * pc.HIT_BLOCK]
        lo = pts[act].min(0) - 0.05
        hi = pts[act].max(0) + 0.05
        want = np.nonzero(((cb[3:] >= lo[:, None]) & (cb[:3] <= hi[:, None]))
                          .all(0))[0]
        np.testing.assert_array_equal(lists[b, :counts[b]], want)


@pytest.mark.gpu
def test_gather_kernel_compiled_on_gpu():
    """The kernel as compiled for the card (no interpret mode)."""
    if jax.devices()[0].platform != "gpu":
        pytest.skip("needs a GPU: the compiled Triton kernel has no CPU "
                    "backend")
    rng = np.random.default_rng(0)
    _, point, normal, active, pos, nrm, flux, valid = _setup(
        rng, 1024, 3000, 0.06)
    tbl, cbox = pc.build_photon_chunks(jnp.asarray(pos), jnp.asarray(nrm),
                                       jnp.asarray(flux), jnp.asarray(valid))
    got = np.asarray(gk.gather_flux(jnp.asarray(point), jnp.asarray(normal),
                                    jnp.asarray(active), cbox, tbl,
                                    np.float32(0.06)))
    want = _brute_force(point, normal, active, pos, nrm, flux, valid, 0.06)
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-5)
