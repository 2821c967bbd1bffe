"""Per-pixel RMSE of the float32 render vs a CPU float64 oracle at the
canonical config (shirley 600x300 spp=32 bounces=8), same positional
samples.

Two modes:
  python -m tools.measure_rmse_spp32 oracle   # CPU f64 -> scenes/oracle_*.npz
  python -m tools.measure_rmse_spp32 device [backend]  # f32 -> RMSE
"""
import sys
import time

import numpy as np


def main():
    mode = sys.argv[1] if len(sys.argv) > 1 else "device"
    w, h, spp, bounces = 600, 300, 32, 8
    import jax

    if mode == "oracle":
        jax.config.update("jax_enable_x64", True)
        jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp
    from pathtracer_tpu.integrator import make_render_fn
    from pathtracer_tpu.models import shirley

    if mode == "oracle":
        scene, cam, bg = shirley.build(w / h, dtype=jnp.float64)
        render = make_render_fn(cam, bg, w, h, spp, bounces,
                                dtype=jnp.float64, backend="xla")
        t0 = time.monotonic()
        img, segs = render(scene)
        img = np.asarray(img, np.float64)
        print(f"oracle render {time.monotonic()-t0:.0f}s "
              f"segs={int(segs)}", flush=True)
        np.savez_compressed(
            "scenes/oracle_shirley_600x300_spp32_f64.npz", img=img)
        return

    backend = sys.argv[2] if len(sys.argv) > 2 else None
    scene, cam, bg = shirley.build(w / h)
    render = make_render_fn(cam, bg, w, h, spp, bounces, backend=backend)
    img, segs = render(scene)
    img = np.asarray(img, np.float64)
    g = np.load("scenes/oracle_shirley_600x300_spp32_f64.npz")["img"]
    rmse = float(np.sqrt(np.mean((img - g) ** 2)))
    mx = float(np.abs(img - g).max())
    print(f"{jax.devices()[0].device_kind} f32 [{backend or 'default'}] "
          f"vs CPU f64 oracle @600x300 spp=32 b=8: "
          f"RMSE={rmse:.2e} max={mx:.2e} (budget 1e-3)", flush=True)


if __name__ == "__main__":
    main()
