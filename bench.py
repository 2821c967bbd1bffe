#!/usr/bin/env python
"""End-to-end benchmark cells on the GPU, one JSON line per metric.

Cells (the reference's three programs at their documented settings, plus
the high-sample shirley config and path-traced ganesha):

  shirley      600x300 spp=32 b=8 (the reference README's command):
               Mrays/s = ray segments traced / warm wall seconds, and the
               cold first frame (compile + run)
  shirley_hq   600x300 spp=512 b=16, Mrays/s
  cornell      PPM 600x600, 75k photons, b=4: sustained s/iter over the
               reference's 10-iteration schedule (iterations 2-11 of one
               quiet run, timed between two syncs) and the cold first
               iteration
  ganesha      the same for the 449k-triangle stand-in mesh
  ganesha_pt   the mesh path-traced, 600x600 spp=8 b=8, Mrays/s

Every line names the platform, device kind and count and the card's name
and power limit. Times end in `block_until_ready`. Without a GPU the
script exits non-zero.

    python bench.py [--cells shirley,cornell] [--backends xla,triton]
"""

import argparse
import json
import subprocess
import time

import jax
import numpy as np

CELLS = ("shirley", "shirley_hq", "cornell", "ganesha", "ganesha_pt")
GANESHA_PLY = "scenes/big_ganesha.ply"
CONTEXT = {}


def emit(metric, value, unit, **extra):
    print(json.dumps({"metric": metric, "value": value, "unit": unit,
                      **extra, **CONTEXT}), flush=True)


def _render_cell(name, backend, width, height, spp, bounces,
                 repeats=3):
    from pathtracer_tpu.integrator import make_render_fn
    from pathtracer_tpu.models import ganesha, shirley

    mesh = None
    if name == "ganesha_pt":
        scene, cam, bg, mesh = ganesha.build_pt(GANESHA_PLY, width / height)
    else:
        scene, cam, bg = shirley.build(width / height)
    render = make_render_fn(cam, bg, width, height, spp, bounces,
                            backend=backend, mesh=mesh)
    t0 = time.perf_counter()
    img, segs = jax.block_until_ready(render(scene))
    first = time.perf_counter() - t0
    walls = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        img, segs = jax.block_until_ready(render(scene))
        walls.append(time.perf_counter() - t0)
    segments = int(segs)
    best = min(walls)
    tag = dict(backend=backend, segments=segments,
               walls_s=[round(w, 6) for w in walls])
    emit(f"{name}_{width}x{height}_spp{spp}_b{bounces}_mrays_per_sec",
         segments / best / 1e6, "Mrays/s", **tag)
    emit(f"{name}_{width}x{height}_spp{spp}_b{bounces}_first_frame_sec",
         first, "s", **tag)
    assert np.isfinite(np.asarray(img)).all()


def _ppm_cell(name, backend, iters=11):
    from pathtracer_tpu.models import cornell, ganesha
    from pathtracer_tpu.ppm import PPMRenderer

    if name == "cornell":
        scene, cam, lights = cornell.build(1.0)
        mesh = bbox = None
    else:
        scene, cam, lights, mesh, bbox = ganesha.build(GANESHA_PLY, 1.0)
    marks = {}

    def cb(i, img_sum):
        if i in (0, iters - 1):
            jax.block_until_ready(img_sum)
            marks[i] = time.perf_counter()

    r = PPMRenderer(scene, cam, lights, 600, 600, iterations=iters,
                    photon_count=75000, max_bounces=4, verbose=False,
                    mesh=mesh, bbox_override=bbox, backend=backend)
    t0 = time.perf_counter()
    img = r.render(checkpoint_cb=cb)
    assert np.isfinite(img).all() and img.max() > 0
    steady = (marks[iters - 1] - marks[0]) / (iters - 1)
    emit(f"{name}_600x600_75k_b4_sec_per_iter", steady, "s/iter",
         backend=backend)
    emit(f"{name}_600x600_75k_b4_first_iter_sec", marks[0] - t0, "s",
         backend=backend)


def main(argv=None):
    ap = argparse.ArgumentParser(description="GPU benchmark cells")
    ap.add_argument("--cells", default=",".join(CELLS))
    ap.add_argument("--backends", default="triton",
                    help="comma-separated tiers to time, in this order")
    args = ap.parse_args(argv)
    devs = jax.devices()
    if devs[0].platform != "gpu":
        raise SystemExit(f"bench.py needs a GPU; JAX found {devs[0].platform}")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    CONTEXT.update(platform=devs[0].platform, device_kind=devs[0].device_kind,
                   device_count=len(devs), card=card)
    for cell in args.cells.split(","):
        for backend in args.backends.split(","):
            if cell == "shirley":
                _render_cell(cell, backend, 600, 300, 32, 8)
            elif cell == "shirley_hq":
                _render_cell(cell, backend, 600, 300, 512, 16)
            elif cell == "ganesha_pt":
                _render_cell(cell, backend, 600, 600, 8, 8)
            elif cell in ("cornell", "ganesha"):
                _ppm_cell(cell, backend)
            else:
                raise SystemExit(f"unknown cell {cell!r}")


if __name__ == "__main__":
    main()
