#!/usr/bin/env python
"""Prove the renderer on the GPU: the reference's three programs at their
documented sizes through the normal entry points, each GPU kernel compared
with the plain XLA version on the card, the tests marked `gpu`, and
per-phase times.

    python chip_smoke.py              # one GPU
    python chip_smoke.py --four-cards # only the multi-device comparisons

One process drives every card (a second JAX process could not reserve the
card's memory). Every phase prints its cold time (compile + first run) and
its warm time (the same call again: in-process jit caches for library
calls, the persistent compile cache for CLI calls) beside the card's name
and power limit. Any failure ends the run with a non-zero exit code; the
last line, printed only when every phase passed, is
    {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
OUT = os.path.join(ROOT, "chiprun_out", "chip_smoke")
SCENES = os.path.join(ROOT, "scenes")
GANESHA_PLY = os.path.join(SCENES, "big_ganesha.ply")
CARD = "card not read"


def card_info() -> str:
    """The cards' name and power limit as nvidia-smi reports them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip()
    return " | ".join(line.strip() for line in out.splitlines())


def log(msg: str) -> None:
    print(msg, flush=True)


def timed(name: str, fn, runs: int = 2):
    """Run fn `runs` times; print cold (first run) and warm (best later
    run) seconds; return the first run's result."""
    times, result = [], None
    for k in range(runs):
        t0 = time.perf_counter()
        r = fn()
        times.append(time.perf_counter() - t0)
        if k == 0:
            result = r
    warm = f"{min(times[1:]):.6f}" if runs > 1 else "not measured"
    log(f"phase={name} cold_s={times[0]:.6f} warm_s={warm} card={CARD}")
    return result


def rmse(a, b) -> float:
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return float(np.sqrt(np.mean((a - b) ** 2)))


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise AssertionError(msg)


def require_gpu(count: int):
    """The JAX devices, or SystemExit when JAX finds fewer GPUs."""
    import jax

    devs = jax.devices()
    if devs[0].platform != "gpu" or len(devs) < count:
        raise SystemExit(f"chip_smoke: needs {count} GPU(s); JAX found "
                         f"{len(devs)} {devs[0].platform} device(s)")
    return devs


# --- phases ---------------------------------------------------------------

def shirley_cli(out_dir, width=600, height=300, spp=32, bounces=8):
    """The reference README's command, with and without the progress bar."""
    from pathtracer_tpu import cli
    from pathtracer_tpu.io.png import read_png

    for flags, tag in (([], "progress"), (["--no-progress"], "no_progress")):
        out = os.path.join(out_dir, f"shirley_{tag}.png")
        argv = ["shirley-spheres", "-d", f"{width},{height}",
                "--samples-per-pixel", str(spp), "--max-ray-bounces",
                str(bounces), "-o", out] + flags
        timed(f"shirley_cli_{tag}", lambda: cli.main(argv))
        png = read_png(out)
        check(png.shape == (height, width, 3) and png.max() > 0,
              f"shirley {tag} png {png.shape} max {png.max()}")


def shirley_oracle(oracle, width=600, height=300, spp=32, bounces=8,
                   limit=1e-3, backend=None, interpret=False):
    """make_render_fn's float image against the committed f64 oracle."""
    from pathtracer_tpu.integrator import make_render_fn
    from pathtracer_tpu.models import shirley

    scene, cam, bg = shirley.build(width / height)
    render = make_render_fn(cam, bg, width, height, spp, bounces,
                            backend=backend, interpret=interpret)
    img = timed("shirley_render_fn",
                lambda: np.asarray(render(scene)[0], np.float64))
    err = rmse(img, np.load(oracle)["img"])
    log(f"shirley_rmse_vs_f64_oracle={err:.3e} limit={limit:.0e}")
    check(err < limit, f"shirley RMSE {err} >= {limit}")
    return img


def ppm_cli(out_dir, scene="cornell-box", width=600, height=600,
            photons=75000, bounces=4, iterations=10, extra=()):
    """A PPM program through the CLI; returns the accumulated image sum
    (from the CLI's checkpoint file), checked finite and non-zero."""
    from pathtracer_tpu import cli

    tag = scene.split("-")[0]
    out = os.path.join(out_dir, f"{tag}.png")
    ck = os.path.join(out_dir, f"{tag}_checkpoint.npz")
    argv = [scene, "-width", str(width), "-height", str(height),
            "-photon-count", str(photons), "-max-bounces", str(bounces),
            "-iterations", str(iterations), "-o", out, "-checkpoint", ck,
            *extra]

    def run():
        if os.path.exists(ck):
            os.remove(ck)  # a checkpoint file would resume the run
        cli.main(argv)
        return np.load(ck)["img_sum"]

    img = timed(f"{tag}_cli_{iterations}iter", run)
    check(img.shape == (height, width, 3), f"{tag} shape {img.shape}")
    check(np.isfinite(img).all() and img.max() > 0,
          f"{tag} image not finite or all zero")
    return img


def cornell_golden(golden, limit=1e-4, backend=None, interpret=False):
    """48x48, one iteration, 1,200 photons, 3 bounces against the CPU
    float32 golden. RMSE, not bit equality: the card sums photons in
    another order."""
    from pathtracer_tpu.models import cornell
    from pathtracer_tpu.ppm import PPMRenderer

    scene, cam, lights = cornell.build(1.0)
    img = timed("cornell_golden_48x48", lambda: PPMRenderer(
        scene, cam, lights, 48, 48, iterations=1, photon_count=1200,
        max_bounces=3, verbose=False, backend=backend,
        interpret=interpret).render())
    g = np.load(golden)["img"]
    err, mx = rmse(img, g), float(np.abs(img - g).max())
    log(f"cornell_golden_rmse={err:.3e} max_abs={mx:.3e} limit={limit:.0e}")
    check(err <= limit, f"cornell golden RMSE {err} > {limit}")


def ganesha_pt(ply, width=600, height=600, spp=8, bounces=8, backend=None,
               interpret=False):
    """One path-traced ganesha frame (the mesh-walk path)."""
    from pathtracer_tpu.integrator import make_render_fn
    from pathtracer_tpu.models import ganesha

    scene, cam, bg, mesh = ganesha.build_pt(ply, width / height)
    render = make_render_fn(cam, bg, width, height, spp, bounces, mesh=mesh,
                            backend=backend, interpret=interpret)
    img = timed("ganesha_pt_frame",
                lambda: np.asarray(render(scene)[0], np.float64))
    check(img.shape == (height, width, 3), f"ganesha_pt shape {img.shape}")
    check(np.isfinite(img).all() and img.max() > 0,
          "ganesha_pt image not finite or all zero")


def _bounce(sampler, scene, org, d, offset, alive, bounce):
    """One path-tracer bounce on the XLA tier: the rays it spawns."""
    from pathtracer_tpu.integrator import make_intersector
    from pathtracer_tpu.ops import quat, shading

    h = make_intersector(scene, "xla")(org, d, alive)
    hit = h["hit"] & alive
    q = shading.shader_quat(h["normal"])
    wo, _, ok = shading.scatter(
        h["mat_kind"], h["albedo"], h["ior"], h["ior_inv"],
        quat.rotate(q, -d), h["hit_front"],
        sampler.get(offset, 2 + 2 * bounce), sampler.get(offset, 3 + 2 * bounce))
    d2 = quat.rotate_inv(q, wo)
    return shading.world_ray(h["point"], d2), d2, hit & ok


def _key_f64(scene, org, d, idx):
    """The a*t key of sphere idx in float64 (ops/spheres.py's formula)."""
    c = np.asarray(scene.center, np.float64)[idx]
    r = np.asarray(scene.radius, np.float64)[idx]
    o, d = org.astype(np.float64), d.astype(np.float64)
    a = (d * d).sum(1)
    bp = ((c - o) * d).sum(1)
    g = r * r - ((c - o) ** 2).sum(1)
    s = np.sqrt(np.maximum(a * (g + bp * bp / a), 0.0))
    return bp + np.where((g >= 0) & (bp >= 0), s, -s)


def sphere_kernel_vs_xla(width=600, height=300, bounces=8, interpret=False):
    """The sphere kernel against spheres.intersect_packed, both on the
    device, over all shirley spheres with pass 0's primary rays and the
    bounce-1 rays they spawn."""
    import jax
    import jax.numpy as jnp

    from pathtracer_tpu.models import shirley
    from pathtracer_tpu.ops import spheres
    from pathtracer_tpu.ops.lds import Sampler
    from pathtracer_tpu.ops.pallas import sphere_kernel as sk

    scene, cam, _ = shirley.build(width / height)
    sampler = Sampler(2 + 2 * bounces)
    y, x = np.mgrid[0:height, 0:width]
    offset = jnp.asarray((y * width + x).reshape(-1), jnp.uint32)
    cx = (jnp.asarray(x.reshape(-1), jnp.float32) + sampler.get(offset, 0)) / width
    cy = 1.0 - (jnp.asarray(y.reshape(-1), jnp.float32)
                + sampler.get(offset, 1)) / height
    d0 = cam.ray_dirs(cx, cy, jnp.float32)
    o0 = jnp.zeros_like(d0)
    alive0 = jnp.ones(d0.shape[:1], bool)
    o1, d1, alive1 = jax.jit(lambda *a: _bounce(sampler, *a, 0))(
        scene, o0, d0, offset, alive0)
    packed = spheres.pack_for_intersect(scene.center, scene.radius,
                                        scene.valid)
    table = sk.pack_spheres(scene.center, scene.radius, scene.valid)
    xla = jax.jit(lambda o, d: spheres.intersect_packed(*packed, scene.valid,
                                                        o, d)[:3])
    kern = jax.jit(lambda o, d, a: sk.intersect_spheres(
        table, o, d, a, interpret=interpret)[:3])
    worst = {}
    for name, o, d, alive in (("primary", o0, d0, alive0),
                              ("bounce1", o1, d1, alive1)):
        at_x, idx_x, hit_x = (np.asarray(v) for v in timed(
            f"sphere_xla_{name}", lambda: jax.block_until_ready(xla(o, d)), 3))
        at_k, idx_k, hit_k = (np.asarray(v) for v in timed(
            f"sphere_kernel_{name}",
            lambda: jax.block_until_ready(kern(o, d, alive)), 3))
        live = np.asarray(alive)
        check((hit_k == (hit_x & live)).all(), f"{name}: hit masks differ")
        h = hit_x & live
        agree = idx_k[h] == idx_x[h]
        share = float(agree.mean()) if h.any() else 1.0
        tie = np.abs(at_k[h] - at_x[h]) <= 1e-5 * np.abs(at_x[h])
        # the a*t key of a grazing or far-off-centre hit is ill-conditioned
        # in float32 (disc = A + 2c.o - |o|^2 + b'^2 cancels), so each
        # side's key is also held against the float64 key of its winner
        at64 = _key_f64(scene, np.asarray(o)[h][agree], np.asarray(d)[h][agree],
                        idx_x[h][agree])
        err_k = np.abs(at_k[h][agree] - at64) / np.abs(at64)
        err_x = np.abs(at_x[h][agree] - at64) / np.abs(at64)
        rel = np.abs(at_k[h][agree] - at_x[h][agree]) / np.abs(at_x[h][agree])
        worst[name] = tuple(float(e.max()) if e.size else 0.0
                            for e in (rel, err_k, err_x))
        log(f"sphere_{name}: live={int(live.sum())} hits={int(h.sum())} "
            f"idx_agree={share:.6f} near_tie_mismatches="
            f"{int((~agree & tie).sum())}/{int((~agree).sum())} "
            f"max_rel_at_kernel_vs_xla={worst[name][0]:.3e} "
            f"vs_f64: kernel={worst[name][1]:.3e} xla={worst[name][2]:.3e}")
        check(share >= 0.9999, f"{name}: idx agrees on {share}")
        check(bool(tie[~agree].all()), f"{name}: a mismatch is no near-tie")
        check(worst[name][0] <= 1e-5
              or worst[name][1] <= max(1e-5, 2.0 * worst[name][2]),
              f"{name}: a*t off by {worst[name]}")
    return worst


def gather_kernel_vs_xla(width=600, height=600, photons=75000, bounces=4,
                         interpret=False):
    """The gather kernel against ppm.hash_gather, both on the device, over
    the cornell eye pass at the first-iteration radius."""
    import jax
    import jax.numpy as jnp

    from pathtracer_tpu import ppm
    from pathtracer_tpu.models import cornell
    from pathtracer_tpu.ops import photon_chunks as pc

    scene, cam, lights = cornell.build(width / height)
    r = ppm.PPMRenderer(scene, cam, lights, width, height,
                        photon_count=photons, max_bounces=bounces,
                        verbose=False).radius(1)
    trace, _, dep_lanes = ppm.make_photon_pass(scene, lights, photons,
                                               bounces, "xla")
    pos, nrm, flux, ok = trace(jnp.uint32(0))
    m = ppm.grid_m_for(photons)
    eye = ppm.make_eye_pass(cam, width, height, bounces, photons, dep_lanes,
                            "xla", grid_m=m, band_rows=height,
                            eff_bounces=1 if ppm.scene_all_diffuse(scene)
                            else bounces)
    fd_pt, fd_nrm, _, fd_ok = jax.jit(eye.walk)(
        jnp.uint32(0), jnp.int32(0), None, scene)
    rj = jnp.float32(r)
    hash_grid = ppm.build_photon_grid(pos, ok, rj, m=m) + (pos, nrm, flux, ok)
    chunks = pc.build_photon_chunks(pos, nrm, flux, ok)
    xla = jax.jit(lambda *a: ppm.hash_gather(*a, grid_m=m,
                                             dep_lanes=dep_lanes))
    kern = jax.jit(ppm.make_eye_pass(
        cam, width, height, bounces, photons, dep_lanes, "xla",
        use_kernel=True, interpret=interpret).make_gather(0))
    want = np.asarray(timed("gather_xla_hash", lambda: jax.block_until_ready(
        xla(fd_pt, fd_nrm, fd_ok, rj, hash_grid)), 3))
    got = np.asarray(timed("gather_kernel_chunks",
                           lambda: jax.block_until_ready(
                               kern(fd_pt, fd_nrm, fd_ok, rj, chunks)), 3))
    tol = 1e-4 * np.abs(want) + 1e-6 * np.abs(want).max()
    excess = float((np.abs(got - want) - tol).max())
    log(f"gather: hits={int(np.asarray(fd_ok).sum())} "
        f"max_abs_diff={float(np.abs(got - want).max()):.3e} "
        f"max_flux={float(np.abs(want).max()):.3e} excess_over_tol={excess:.3e}")
    check(excess <= 0.0, "gather kernel outside 1e-4 rel + 1e-6 max tolerance")
    check(float(np.abs(want).max()) > 0, "gather saw no photons")


def tiers_whole_image(ply, width=600, height=600, photons=75000, bounces=4,
                      limit=1e-4, interpret=False):
    """One PPM iteration of cornell and of ganesha, kernel tier against
    the XLA tier, both on the device."""
    from pathtracer_tpu.models import cornell, ganesha
    from pathtracer_tpu.ppm import PPMRenderer

    builds = {"cornell": lambda: cornell.build(width / height) + (None, None),
              "ganesha": lambda: ganesha.build(ply, width / height)}
    for name, build in builds.items():
        imgs = {}
        for backend in ("xla", "triton"):
            scene, cam, lights, mesh, bbox = build()
            imgs[backend] = timed(f"{name}_1iter_{backend}", lambda: PPMRenderer(
                scene, cam, lights, width, height, iterations=1,
                photon_count=photons, max_bounces=bounces, verbose=False,
                mesh=mesh, bbox_override=bbox, backend=backend,
                interpret=interpret and backend == "triton").render())
        for backend, img in imgs.items():
            check(np.isfinite(img).all() and img.max() > 0,
                  f"{name} {backend}: image not finite or all zero")
        err = rmse(imgs["triton"], imgs["xla"])
        scale = rmse(imgs["xla"], 0.0)
        log(f"{name}_tiers_rmse={err:.3e} rms_xla={scale:.3e} "
            f"max_xla={float(imgs['xla'].max()):.3e} "
            f"max_triton={float(imgs['triton'].max()):.3e} "
            f"rel_rmse={err / scale:.3e} limit={limit:.0e} (abs and rel)")
        check(err <= limit and err <= limit * scale,
              f"{name}: kernel vs xla RMSE {err} over {limit} (image RMS "
              f"{scale})")


def gpu_marked_tests():
    """The tests marked `gpu` (the compiled kernels against the plain
    versions on small inputs), run in this process on the card; every one
    must pass, none may skip."""
    import pytest

    class Tally:
        def __init__(self):
            self.passed, self.other = 0, []

        def pytest_runtest_logreport(self, report):
            if report.when == "call" and report.passed:
                self.passed += 1
            elif report.failed or report.skipped:
                self.other.append(f"{report.nodeid} {report.outcome}")

    tally = Tally()
    rc = timed("gpu_marked_tests", lambda: pytest.main(
        ["-q", "-m", "gpu", "-p", "no:cacheprovider",
         os.path.join(ROOT, "tests")], plugins=[tally]), 1)
    log(f"gpu_marked_tests: rc={int(rc)} passed={tally.passed} "
        f"not_passed={tally.other}")
    check(rc == 0 and tally.passed > 0 and not tally.other,
          "a test marked gpu did not pass on the card")


def four_cards(devices, width=600, height=300, spp=32, bounces=8,
               ppm_size=600, photons=75000, iterations=3, limit=1e-5,
               backend=None, interpret=False):
    """The multi-device paths against one device, in one process: the
    sharded shirley render (dp=4) and both sharded photon-map layouts."""
    import jax

    from pathtracer_tpu.integrator import make_render_fn
    from pathtracer_tpu.models import cornell, shirley
    from pathtracer_tpu.parallel.mesh import make_mesh, make_sharded_render_fn
    from pathtracer_tpu.ppm import PPMRenderer

    n = len(devices)
    scene, cam, bg = shirley.build(width / height)
    with jax.default_device(devices[0]):
        one = timed("shirley_1card", lambda: np.asarray(make_render_fn(
            cam, bg, width, height, spp, bounces, backend=backend,
            interpret=interpret)(scene)[0], np.float64))
    render = make_sharded_render_fn(cam, bg, width, height, spp, bounces,
                                    make_mesh(n, 1, devices), backend=backend,
                                    interpret=interpret)
    many = timed(f"shirley_{n}cards",
                 lambda: np.asarray(render(scene)[0], np.float64))
    err = rmse(many, one)
    log(f"shirley_{n}cards_rmse_vs_1card={err:.3e} limit={limit:.0e}")
    check(err <= limit, f"sharded shirley RMSE {err}")

    scene, cam, lights = cornell.build(1.0)
    kw = dict(iterations=iterations, photon_count=photons, max_bounces=4,
              verbose=False, backend=backend, interpret=interpret)
    ref = timed("cornell_1card", lambda: PPMRenderer(
        scene, cam, lights, ppm_size, ppm_size, devices=devices[:1],
        **kw).render(), 1)
    for mode in ("ring", True):
        tag = "ring" if mode == "ring" else "host"
        img = timed(f"cornell_{n}cards_{tag}", lambda: PPMRenderer(
            scene, cam, lights, ppm_size, ppm_size, devices=devices,
            shard_photon_map=mode, **kw).render(), 1)
        err = rmse(img, ref)
        log(f"cornell_{n}cards_{tag}_rmse_vs_1card={err:.3e} "
            f"limit={limit:.0e}")
        check(err <= limit, f"cornell {tag} RMSE {err}")
    stats = [d.memory_stats() for d in devices]
    if None in stats:  # the CPU backend keeps no allocator statistics
        log("peak_bytes_in_use per device: not measured")
        return
    peaks = [st["peak_bytes_in_use"] for st in stats]
    log(f"peak_bytes_in_use per device: {peaks}")
    check(min(peaks) >= 0.1 * max(peaks),
          "one device holds nearly all the work")


def main(argv=None) -> int:
    global CARD
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the four-GPU comparisons")
    args = ap.parse_args(argv)
    count = 4 if args.four_cards else 1
    devices = require_gpu(count)[:count]
    CARD = card_info()
    d0 = devices[0]
    log(f"device: platform={d0.platform} kind={d0.device_kind} "
        f"count={len(devices)}")
    log(f"card: {CARD}")
    shutil.rmtree(OUT, ignore_errors=True)
    os.makedirs(OUT)
    t0 = time.perf_counter()
    if args.four_cards:
        four_cards(devices)
    else:
        shirley_cli(OUT)
        shirley_oracle(os.path.join(
            SCENES, "oracle_shirley_600x300_spp32_f64.npz"))
        ppm_cli(OUT)
        cornell_golden(os.path.join(SCENES, "golden_cornell_48x48_1iter.npz"))
        ppm_cli(OUT, "ganesha", iterations=3,
                extra=("-ganesha-ply", GANESHA_PLY))
        ganesha_pt(GANESHA_PLY)
        sphere_kernel_vs_xla()
        gather_kernel_vs_xla()
        tiers_whole_image(GANESHA_PLY)
        gpu_marked_tests()
    log(f"total_s={time.perf_counter() - t0:.1f} card={CARD}")
    log(json.dumps({"ok": True, "device": {
        "platform": d0.platform, "kind": d0.device_kind,
        "count": len(devices)}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
