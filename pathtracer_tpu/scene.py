"""Scene representation: structure-of-arrays geometry + materials.

The reference injects geometry as a closure `intersect : Ray.t -> Hit.t option`
and materials as closures inside `Hit.t` (`hit.ml:3-7`). Closures don't
vectorize; the data-parallel design is data: spheres are SoA arrays (the same
layout the reference's Rust AVX kernel uses for leaves —
`sphere-intersect-rs/src/lib.rs`), and materials are per-primitive codes +
parameter arrays dispatched with masks.

Material codes (material.ml:3-14): 0=Lambertian, 1=Metal, 2=Dielectric.
Texture codes (texture.ml:20-31): 0=solid (color_a), 1=checker (color_a even /
color_b odd, integer-parity of scaled uv).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import jax.numpy as jnp

LAMBERTIAN = 0
METAL = 1
DIELECTRIC = 2

TEX_SOLID = 0
TEX_CHECKER = 1


class Scene(NamedTuple):
    """SoA scene (spheres + optional triangles), in camera space.

    Mixed-shape scenes mirror the reference cornell-box Shape sum type
    (cornell-box/bin/main.ml:93-155) as two SoA pools sharing one material
    column layout.
    """

    center: jnp.ndarray  # (S, 3) f32
    radius: jnp.ndarray  # (S,) f32
    mat_kind: jnp.ndarray  # (S,) i32
    tex_kind: jnp.ndarray  # (S,) i32
    color_a: jnp.ndarray  # (S, 3) f32 — solid color / checker even color
    color_b: jnp.ndarray  # (S, 3) f32 — checker odd color
    checker_w: jnp.ndarray  # (S,) f32 — checker width-1 (texture.ml:22)
    checker_h: jnp.ndarray  # (S,) f32 — checker height-1
    ior: jnp.ndarray  # (S,) f32 — dielectric index
    ior_inv: jnp.ndarray  # (S,) f32
    valid: jnp.ndarray  # (S,) bool — False for padding entries
    shade_pack: jnp.ndarray  # (S, 16) f32 — all shading params, one gather/hit
    # triangles: a + u*e1 + v*e2 parameterization (triangle.ml:74-98)
    tri_pack: jnp.ndarray = None  # (T, 27): a(3) e1(3) e2(3) tex(6) mat(12)
    tri_valid: jnp.ndarray = None  # (T,) bool

    @property
    def count(self) -> int:
        return self.center.shape[0]

    @property
    def tri_count(self) -> int:
        return 0 if self.tri_pack is None else self.tri_pack.shape[0]

    # bounding box over valid primitives (host use; Bbox analog bbox.ml:14-24)
    def bbox(self):
        lo = np.full(3, np.inf)
        hi = np.full(3, -np.inf)
        c = np.asarray(self.center)[np.asarray(self.valid)]
        r = np.asarray(self.radius)[np.asarray(self.valid)][:, None]
        if len(c):
            lo = np.minimum(lo, (c - r).min(0))
            hi = np.maximum(hi, (c + r).max(0))
        if self.tri_count:
            tp = np.asarray(self.tri_pack)[np.asarray(self.tri_valid)]
            if len(tp):
                a = tp[:, 0:3]
                b = a + tp[:, 3:6]
                cc = a + tp[:, 6:9]
                v = np.concatenate([a, b, cc])
                lo = np.minimum(lo, v.min(0))
                hi = np.maximum(hi, v.max(0))
        return lo, hi


SphereScene = Scene  # historical alias


# tri_pack column layout
TRI_A = slice(0, 3)
TRI_E1 = slice(3, 6)
TRI_E2 = slice(6, 9)
TRI_TEX = slice(9, 15)  # ua va ub vb uc vc
TRI_MAT = slice(15, 27)  # same 12 columns as shade_pack[4:16]


# shade_pack column layout
_PK_CENTER = slice(0, 3)
_PK_RADIUS = 3
_PK_MAT = 4
_PK_TEX = 5
_PK_CA = slice(6, 9)
_PK_CB = slice(9, 12)
_PK_CW = 12
_PK_CH = 13
_PK_IOR = 14
_PK_IOR_INV = 15


def shade_pack_columns(pk):
    """Unpack a gathered (N, 16) shading row into named columns."""
    return dict(
        center=pk[..., _PK_CENTER],
        mat_kind=pk[..., _PK_MAT],
        tex_kind=pk[..., _PK_TEX],
        color_a=pk[..., _PK_CA],
        color_b=pk[..., _PK_CB],
        checker_w=pk[..., _PK_CW],
        checker_h=pk[..., _PK_CH],
        ior=pk[..., _PK_IOR],
        ior_inv=pk[..., _PK_IOR_INV],
    )


class SceneBuilder:
    """Host-side accumulation of spheres; produces a padded SphereScene."""

    def __init__(self):
        self.rows = []

    def add_sphere(self, center, radius, mat_kind, color_a=(0, 0, 0),
                   color_b=(0, 0, 0), tex_kind=TEX_SOLID, checker_wh=(1, 1),
                   ior=1.5):
        self.rows.append(dict(
            center=np.asarray(center, np.float64), radius=float(radius),
            mat_kind=int(mat_kind), tex_kind=int(tex_kind),
            color_a=np.asarray(color_a, np.float64),
            color_b=np.asarray(color_b, np.float64),
            checker_wh=(float(checker_wh[0]), float(checker_wh[1])),
            ior=float(ior)))

    def add_triangle(self, a, b, c, mat_kind, tex_a=(0, 0), tex_b=(0, 0),
                     tex_c=(0, 0), color_a=(0, 0, 0), color_b=(0, 0, 0),
                     tex_kind=TEX_SOLID, checker_wh=(1, 1), ior=1.5):
        if not hasattr(self, "tris"):
            self.tris = []
        self.tris.append(dict(
            verts=np.asarray([a, b, c], np.float64),
            tex=np.asarray([tex_a, tex_b, tex_c], np.float64),
            mat_kind=int(mat_kind), tex_kind=int(tex_kind),
            color_a=np.asarray(color_a, np.float64),
            color_b=np.asarray(color_b, np.float64),
            checker_wh=(float(checker_wh[0]), float(checker_wh[1])),
            ior=float(ior)))

    def add_quad(self, a, u, v, **mat):
        """Axis quad as a 2-triangle fan, reference winding
        (cornell-box/bin/main.ml:30-47): corners a, b=a+v, c=b+u, d=a+u with
        tex coords t00, t10, t11, t01; fan from a: (a,b,c), (a,c,d)."""
        a = np.asarray(a, np.float64)
        u = np.asarray(u, np.float64)
        v = np.asarray(v, np.float64)
        b, c, d = a + v, a + v + u, a + u
        t00, t10, t11, t01 = (0, 0), (1, 0), (1, 1), (0, 1)
        # triangle_fan emits (o,a,b) in reverse discovery order; intersection
        # is winding-agnostic here so list order only affects tie-breaks
        self.add_triangle(a, b, c, tex_a=t00, tex_b=t10, tex_c=t11, **mat)
        self.add_triangle(a, c, d, tex_a=t00, tex_b=t11, tex_c=t01, **mat)

    def build(self, camera=None, pad_to: int = 8, dtype=jnp.float32) -> SphereScene:
        # pad_to 8 = the Pallas sphere loop's unroll factor; larger padding
        # just adds dead loop iterations (a 128-pad cost 17% on shirley)
        n = len(self.rows)
        s = max(pad_to, -(-n // pad_to) * pad_to)
        center = np.zeros((s, 3), np.float64)
        radius = np.zeros(s, np.float64)
        mat_kind = np.zeros(s, np.int32)
        tex_kind = np.zeros(s, np.int32)
        color_a = np.zeros((s, 3), np.float64)
        color_b = np.zeros((s, 3), np.float64)
        checker_w = np.ones(s, np.float64)
        checker_h = np.ones(s, np.float64)
        ior = np.full(s, 1.5, np.float64)
        valid = np.zeros(s, bool)
        for i, r in enumerate(self.rows):
            center[i] = r["center"]
            radius[i] = r["radius"]
            mat_kind[i] = r["mat_kind"]
            tex_kind[i] = r["tex_kind"]
            color_a[i] = r["color_a"]
            color_b[i] = r["color_b"]
            # checker scales by (width-1, height-1) — texture.ml:21-22
            checker_w[i] = r["checker_wh"][0] - 1.0
            checker_h[i] = r["checker_wh"][1] - 1.0
            ior[i] = r["ior"]
            valid[i] = True
        if camera is not None:
            # scene-to-camera-space pre-transform (shirley_spheres/bin/main.ml:258-261)
            center[:n] = camera.transform_points(center[:n])
        pack = np.zeros((s, 16), np.float64)
        pack[:, 0:3] = center
        pack[:, 3] = radius
        pack[:, 4] = mat_kind
        pack[:, 5] = tex_kind
        pack[:, 6:9] = color_a
        pack[:, 9:12] = color_b
        pack[:, 12] = checker_w
        pack[:, 13] = checker_h
        pack[:, 14] = ior
        pack[:, 15] = 1.0 / ior

        tris = getattr(self, "tris", [])
        tri_pack = None
        tri_valid = None
        if tris:
            tn = len(tris)
            tcap = -(-tn // 128) * 128
            tp = np.zeros((tcap, 27), np.float64)
            tv = np.zeros(tcap, bool)
            for i, tr in enumerate(tris):
                verts = tr["verts"]
                if camera is not None:
                    verts = camera.transform_points(verts)
                tp[i, 0:3] = verts[0]
                tp[i, 3:6] = verts[1] - verts[0]
                tp[i, 6:9] = verts[2] - verts[0]
                tp[i, 9:15] = tr["tex"].reshape(-1)
                tp[i, 15] = tr["mat_kind"]
                tp[i, 16] = tr["tex_kind"]
                tp[i, 17:20] = tr["color_a"]
                tp[i, 20:23] = tr["color_b"]
                tp[i, 23] = tr["checker_wh"][0] - 1.0
                tp[i, 24] = tr["checker_wh"][1] - 1.0
                tp[i, 25] = tr["ior"]
                tp[i, 26] = 1.0 / tr["ior"]
                tv[i] = True
            # cast on HOST first: jnp.asarray(f64_numpy, f32) compiles a
            # per-shape convert_element_type program on the device; a
            # numpy cast + h2d of the final dtype compiles nothing
            np_dtype = np.dtype(str(jnp.dtype(dtype)))
            tri_pack = jnp.asarray(np.asarray(tp, np_dtype))
            tri_valid = jnp.asarray(tv)
        else:
            np_dtype = np.dtype(str(jnp.dtype(dtype)))
        host = lambda x: jnp.asarray(np.asarray(x, np_dtype))
        return SphereScene(
            center=host(center),
            radius=host(radius),
            mat_kind=jnp.asarray(mat_kind),
            tex_kind=jnp.asarray(tex_kind),
            color_a=host(color_a),
            color_b=host(color_b),
            checker_w=host(checker_w),
            checker_h=host(checker_h),
            ior=host(ior),
            ior_inv=host(1.0 / ior),
            valid=jnp.asarray(valid),
            shade_pack=host(pack),
            tri_pack=tri_pack,
            tri_valid=tri_valid,
        )


def eval_texture(tex_kind, color_a, color_b, checker_w, checker_h, u, v):
    """Masked texture evaluation (texture.ml:20-31).

    checker parity: trunc(u * (width-1)) & 1 vs trunc(v * (height-1)) & 1.
    """
    px = jnp.trunc(u * checker_w).astype(jnp.int32) & 1
    py = jnp.trunc(v * checker_h).astype(jnp.int32) & 1
    checker = jnp.where((px == py)[..., None], color_a, color_b)
    return jnp.where((tex_kind == TEX_CHECKER)[..., None], checker, color_a)
