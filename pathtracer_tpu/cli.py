"""Command-line harness with the reference's flag surface.

Path-traced scenes take the cmdliner flags of `render_command.ml:16-47`:
  -d/--dimension W,H (required) | --samples-per-pixel INT (default 1)
  -o/--output PATH (default output.png) | --no-progress
  --max-ray-bounces INT (default 8)
plus shirley's `--no-simd` analog `--interpreter` (force the plain XLA
tier instead of the GPU kernels — the A/B oracle in the spirit of
shirley_spheres/bin/main.ml:14-23).

PPM scenes (cornell-box, ganesha) take the Stdlib.Arg-style flags of
`progressive_photon_map.ml:17-54` (exposed here in both `-flag` and `--flag`
spellings): -width -height -iterations -photon-count -alpha -o -no-progress
-max-bounces, plus ganesha's -ganesha-ply and -stop-after-bvh.
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np


def _parse_dimension(s: str):
    try:
        w, h = s.split(",")
        return int(w), int(h)
    except ValueError:
        raise argparse.ArgumentTypeError(f"expected WIDTH,HEIGHT, got {s!r}")


def add_render_args(p: argparse.ArgumentParser) -> None:
    p.add_argument("-d", "--dimension", type=_parse_dimension, required=True,
                   metavar="WIDTH,HEIGHT", help="image dimensions")
    p.add_argument("--samples-per-pixel", type=int, default=1, metavar="INT",
                   help="trace INT camera rays per pixel")
    p.add_argument("-o", "--output", default="output.png", metavar="PATH",
                   help="write image to PATH")
    p.add_argument("--no-progress", action="store_true",
                   help="suppress progress bar")
    p.add_argument("--max-ray-bounces", type=int, default=8, metavar="INT",
                   help="max ray bounces")
    p.add_argument("--interpreter", action="store_true",
                   help="force the plain XLA tier (A/B oracle; the "
                        "--no-simd analog)")
    p.add_argument("--profile", metavar="DIR", default=None,
                   help="capture a jax.profiler trace of the render to DIR")


def run_shirley(argv=None) -> None:
    parser = argparse.ArgumentParser("shirley_spheres",
                                     description="Render Shirley spheres.")
    add_render_args(parser)
    args = parser.parse_args(argv)
    width, height = args.dimension

    from .models import shirley
    from .integrator import make_render_fn, render_with_progress
    from .io.png import write_png
    from .utils.progress import ProgressBar

    t0 = time.monotonic()
    scene, cam, background = shirley.build(width / height)
    build_ms = (time.monotonic() - t0) * 1e3
    print(f"dim = {width} x {height};")
    print(f"#spheres = {int(np.asarray(scene.valid).sum())}")
    print(f"build time = {build_ms:.3f} ms")

    backend = "xla" if args.interpreter else None
    profile_cm = None
    if args.profile:
        import jax
        profile_cm = jax.profiler.trace(args.profile)
        profile_cm.__enter__()
    t0 = time.monotonic()
    if args.no_progress:
        render = make_render_fn(cam, background, width, height,
                                args.samples_per_pixel, args.max_ray_bounces,
                                backend=backend)
        img, _segs = render(scene)
        img = np.asarray(img)
    else:
        bar = ProgressBar(width * height * args.samples_per_pixel)
        img, _segs = render_with_progress(
            cam, background, scene, width, height, args.samples_per_pixel,
            args.max_ray_bounces, progress=bar.update, backend=backend)
        bar.close()
    elapsed_ms = (time.monotonic() - t0) * 1e3
    if profile_cm is not None:
        profile_cm.__exit__(None, None, None)
    write_png(args.output, img)
    print(f"rendered in: {elapsed_ms:.3f} ms")


def add_ppm_args(p: argparse.ArgumentParser) -> None:
    """Stdlib.Arg-style flag set of the PPM scenes (ppm.ml:17-54); both
    -flag and --flag spellings are accepted."""
    p.add_argument("-width", "--width", type=int, default=600, metavar="INT",
                   help="image width")
    p.add_argument("-height", "--height", type=int, default=600, metavar="INT",
                   help="image height")
    p.add_argument("-iterations", "--iterations", type=int, default=10,
                   metavar="INT", help="# photon-map iterations")
    p.add_argument("-photon-count", "--photon-count", type=int, default=75000,
                   metavar="INT", help="#photons per iteration")
    p.add_argument("-alpha", "--alpha", type=float, default=2.0 / 3.0,
                   metavar="FLOAT", help="photon-map alpha in (0,1)")
    p.add_argument("-o", "--output", default="output.png", metavar="FILE",
                   help="output file")
    p.add_argument("-no-progress", "--no-progress", action="store_true",
                   help="suppress progress monitor")
    p.add_argument("-max-bounces", "--max-bounces", type=int, default=4,
                   metavar="INT", help="max ray bounces")
    p.add_argument("-checkpoint", "--checkpoint", metavar="FILE", default=None,
                   help="save/resume iteration state (img_sum + counter) "
                        "to FILE every iteration")
    p.add_argument("-shard-photon-map", "--shard-photon-map", nargs="?",
                   const="host", default=None, choices=("host", "ring"),
                   help="multi-device: keep each device's photon chunks "
                        "local and gather flux from per-device sub-grids "
                        "(photon-map memory per device scales 1/n_devices)."
                        " 'host' (default when given bare) fans bands out "
                        "as separate device calls; 'ring' runs one "
                        "shard_map where sub-grids rotate over the device "
                        "ring with ppermute")


def _shard_mode(args):
    """Map the CLI value to PPMRenderer.shard_photon_map: absent -> off,
    bare/'host' -> host-orchestrated sub-grids, 'ring' -> shard_map ring."""
    if args.shard_photon_map is None:
        return False
    return "ring" if args.shard_photon_map == "ring" else True


def run_cornell(argv=None) -> None:
    parser = argparse.ArgumentParser(
        "cornell-box", description="Render the Cornell box by progressive "
        "photon mapping.")
    add_ppm_args(parser)
    args = parser.parse_args(argv)

    from .models import cornell
    from .ppm import PPMRenderer

    t0 = time.monotonic()
    scene, cam, lights = cornell.build(args.width / args.height)
    renderer = PPMRenderer(scene, cam, lights, args.width, args.height,
                           iterations=args.iterations,
                           photon_count=args.photon_count, alpha=args.alpha,
                           max_bounces=args.max_bounces,
                           verbose=not args.no_progress,
                           shard_photon_map=_shard_mode(args))
    renderer.render(output=args.output, checkpoint_path=args.checkpoint)
    print(f"render time = {(time.monotonic() - t0) * 1e3:.3f} ms")


def run_ganesha(argv=None) -> None:
    parser = argparse.ArgumentParser(
        "ganesha", description="Render a PLY mesh (ganesha) by progressive "
        "photon mapping.")
    add_ppm_args(parser)
    parser.add_argument("-ganesha-ply", "--ganesha-ply", default="ganesha.ply",
                        metavar="FILE", help="path to ganesha.ply")
    parser.add_argument("-stop-after-bvh", "--stop-after-bvh",
                        action="store_true", help="stop after BVH build")
    args = parser.parse_args(argv)

    from .models import ganesha
    from .ppm import PPMRenderer

    print(f"dim = {args.width} x {args.height};")
    t_total = time.monotonic()
    cam = ganesha.make_camera(args.width / args.height)
    t0 = time.monotonic()
    mesh_build = ganesha.build(args.ganesha_ply, args.width / args.height)
    scene, cam, lights, mesh, bbox = mesh_build
    build_ms = (time.monotonic() - t0) * 1e3
    print(f"#triangles = {mesh.n_tris}")
    print(f"tree depth = {mesh.depth}")
    print(f"build time = {build_ms:.3f} ms")
    bvh_bytes = (mesh.meta_np.nbytes + 2 * mesh.meta_np.shape[0] * 12
                 + 3 * mesh.n_tris * 12)
    print(f"bvh bytes = {bvh_bytes}  "
          f"(the reference prints Obj.reachable_words here)")
    hist = mesh.leaf_histogram()
    print("leaf lengths =")
    print(" ".join(f"((size {s})(count {c}))" for s, c in hist.items()))
    if args.stop_after_bvh:
        print("Stop after bvh build")
        return
    lo, hi = bbox
    print(f"ganesha bbox = ((min({lo[0]:.6g} {lo[1]:.6g} {lo[2]:.6g}))"
          f"(max({hi[0]:.6g} {hi[1]:.6g} {hi[2]:.6g})))")
    renderer = PPMRenderer(scene, cam, lights, args.width, args.height,
                           iterations=args.iterations,
                           photon_count=args.photon_count, alpha=args.alpha,
                           max_bounces=args.max_bounces,
                           verbose=not args.no_progress, mesh=mesh,
                           bbox_override=bbox,
                           shard_photon_map=_shard_mode(args))
    renderer.render(output=args.output, checkpoint_path=args.checkpoint)
    print(f"elapsed ms: {(time.monotonic() - t_total) * 1e3:.3f}")


def run_ply_describe(argv=None) -> None:
    """PLY inspection tool (ply_format/bin/ply_describe.ml:10-95)."""
    parser = argparse.ArgumentParser("ply_describe",
                                     description="Describe a PLY file.")
    parser.add_argument("file", help="PLY file path")
    args = parser.parse_args(argv)

    from .io import ply

    t0 = time.monotonic()
    p = ply.load(args.file)
    parse_ms = (time.monotonic() - t0) * 1e3
    print(f"format = {p.fmt}")
    for el in p.elements:
        print(f"element {el.name} (count {el.count})")
        for pr in el.properties:
            if pr.is_list:
                print(f"  property list {pr.length_dtype} {pr.elt_dtype} "
                      f"{pr.name}")
            else:
                print(f"  property {pr.dtype} {pr.name}")
    for el, cols in p.data.items():
        for name, col in cols.items():
            if isinstance(col, list):
                lens = {}
                for row in col:
                    lens[len(row)] = lens.get(len(row), 0) + 1
                print(f"{el}.{name}: rows, face-size histogram = {lens}")
            elif col.ndim == 2:
                lens = {col.shape[1]: col.shape[0]}
                print(f"{el}.{name}: rows, face-size histogram = {lens}")
            elif np.issubdtype(col.dtype, np.floating):
                finite = np.isfinite(col).all()
                print(f"{el}.{name}: float min={col.min():.6g} "
                      f"max={col.max():.6g} all-finite={finite}")
            else:
                print(f"{el}.{name}: int min={col.min()} max={col.max()}")
    print(f"parse time = {parse_ms:.3f} ms")


def main(argv=None) -> None:
    argv = list(sys.argv[1:] if argv is None else argv)
    commands = {
        "shirley-spheres": run_shirley,
        "shirley_spheres": run_shirley,
        "cornell-box": run_cornell,
        "cornell_box": run_cornell,
        "ganesha": run_ganesha,
        "ply-describe": run_ply_describe,
        "ply_describe": run_ply_describe,
    }
    if not argv or argv[0] in ("-h", "--help"):
        print("usage: python -m pathtracer_tpu <command> [args]\n"
              f"commands: {', '.join(sorted(set(commands)))}")
        return
    cmd = argv[0]
    if cmd not in commands:
        print(f"unknown command {cmd!r}; available: {sorted(set(commands))}",
              file=sys.stderr)
        sys.exit(2)
    commands[cmd](argv[1:])


if __name__ == "__main__":
    main()
