"""pathtracer_tpu — a JAX (XLA + Pallas-Triton) quasi-Monte-Carlo path
tracing framework with the capabilities of the reference OCaml/Rust renderer
(dalev/path-tracer-ocaml), re-designed as a data-parallel device program.

Architecture (inverted from the reference's closure-per-ray recursive design):

- SoA wavefront state: rays/hits live in structure-of-arrays jnp arrays with a
  trailing dim of 3 for vectors; every per-ray quantity is a batched array.
- Bounce-synchronous loop: the recursive `trace_path` bounce loop of the
  reference (integrator.ml:30-68) becomes an unrolled/`lax.scan` loop over
  bounce index carrying (origin, direction, attenuation, alive, radiance).
- Masked material dispatch: the reference's `Scatter.t` ADT branch becomes
  `jnp.where` selection over lambertian/metal/dielectric results.
- Deterministic positional sampling: the Roberts R_d low-discrepancy sequence
  (low_discrepancy_sequence.ml) is a pure function of (offset, dimension) and
  is evaluated here in 64-bit fixed point with uint32 limb arithmetic so it is
  exact-to-2^-64 without 64-bit floats on the device.
- Two tiers: plain XLA everywhere, and on a GPU Pallas-Triton kernels for the
  sphere nearest-hit and the photon gather (ops/pallas/).
- Data parallelism: the reference's domainslib tile fork-join becomes
  `shard_map` over a `jax.sharding.Mesh`, with the film reduced by `psum`.
"""

import os

__version__ = "0.1.0"

CACHE_ENV = "JAX_COMPILATION_CACHE_DIR"
DEFAULT_CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), ".jax_cache")


def compilation_cache_dir(environ=None) -> str:
    """Where compiled programs persist across processes: the directory that
    JAX_COMPILATION_CACHE_DIR names when it is set (JAX reads the variable
    itself), otherwise `.jax_cache/` at the root of the checkout."""
    environ = os.environ if environ is None else environ
    return environ.get(CACHE_ENV) or DEFAULT_CACHE_DIR


def _enable_compilation_cache():
    """Renders compile once per checkout, not once per process (the
    ganesha PPM programs alone take minutes to compile)."""
    if os.environ.get(CACHE_ENV):
        return  # JAX already took the directory from the environment
    import jax

    os.makedirs(DEFAULT_CACHE_DIR, exist_ok=True)
    jax.config.update("jax_compilation_cache_dir", DEFAULT_CACHE_DIR)


_enable_compilation_cache()
