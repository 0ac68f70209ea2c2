"""Homogeneous 4x4 transform helpers.

Reimplements the reference transform conventions (reference:
src/sdfs/sdfHelpers.f90:23-183, src/vector_class.f90:292-304) in JAX.

Convention: a point ``p`` is transformed as the homogeneous *row* vector
product ``[x, y, z, 1] @ M`` -- i.e. translations live in row 3 (0-indexed)
of the matrix.  SDFs store the *inverse* of the world transform (scenes call
``invert(translate(pos))``, reference: src/setupGeometry.f90:64).

All functions are jittable and differentiable; angles are in degrees to match
the reference API.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def deg2rad(angle):
    return jnp.asarray(angle) * (jnp.pi / 180.0)


def identity(dtype=jnp.float32) -> jnp.ndarray:
    return jnp.eye(4, dtype=dtype)


def apply_transform(m: jnp.ndarray, p: jnp.ndarray) -> jnp.ndarray:
    """``[p, 1] @ m`` restricted to the first three output components.

    ``p`` may be batched ``[..., 3]``; ``m`` is ``[4, 4]``.  Expanded
    elementwise rather than ``p @ m``: an f32 matmul at default precision
    may run on reduced-precision tensor cores (TF32 keeps ~3 decimal
    digits), an error on every SDF evaluation; the expansion stays in
    full f32.
    """
    return (
        p[..., 0:1] * m[0, :3]
        + p[..., 1:2] * m[1, :3]
        + p[..., 2:3] * m[2, :3]
        + m[3, :3]
    )


def apply_rotation(m: jnp.ndarray, v: jnp.ndarray) -> jnp.ndarray:
    """Rotate a direction (no translation part; same elementwise
    expansion as :func:`apply_transform`)."""
    return (
        v[..., 0:1] * m[0, :3]
        + v[..., 1:2] * m[1, :3]
        + v[..., 2:3] * m[2, :3]
    )


def translate(o) -> jnp.ndarray:
    """Translation matrix (reference: src/sdfs/sdfHelpers.f90:169-182)."""
    o = jnp.asarray(o)
    m = jnp.eye(4, dtype=o.dtype)
    m = m.at[3, :3].set(o)
    return m


def rotate_x(angle) -> jnp.ndarray:
    """Rotation about x by ``angle`` degrees (sdfHelpers.f90:23-41)."""
    a = deg2rad(angle)
    c, s = jnp.cos(a), jnp.sin(a)
    z, one = jnp.zeros_like(c), jnp.ones_like(c)
    return jnp.stack(
        [
            jnp.stack([one, z, z, z]),
            jnp.stack([z, c, s, z]),
            jnp.stack([z, -s, c, z]),
            jnp.stack([z, z, z, one]),
        ]
    )


def rotate_y(angle) -> jnp.ndarray:
    """Rotation about y by ``angle`` degrees (sdfHelpers.f90:43-62)."""
    a = deg2rad(angle)
    c, s = jnp.cos(a), jnp.sin(a)
    z, one = jnp.zeros_like(c), jnp.ones_like(c)
    return jnp.stack(
        [
            jnp.stack([c, z, -s, z]),
            jnp.stack([z, one, z, z]),
            jnp.stack([s, z, c, z]),
            jnp.stack([z, z, z, one]),
        ]
    )


def rotate_z(angle) -> jnp.ndarray:
    """Rotation about z by ``angle`` degrees (sdfHelpers.f90:64-83)."""
    a = deg2rad(angle)
    c, s = jnp.cos(a), jnp.sin(a)
    z, one = jnp.zeros_like(c), jnp.ones_like(c)
    return jnp.stack(
        [
            jnp.stack([c, s, z, z]),
            jnp.stack([-s, c, z, z]),
            jnp.stack([z, z, one, z]),
            jnp.stack([z, z, z, one]),
        ]
    )


def rotmat(axis: jnp.ndarray, angle) -> jnp.ndarray:
    """Axis-angle rotation, angle in degrees (sdfHelpers.f90:85-112)."""
    axis = jnp.asarray(axis)
    u = axis / jnp.linalg.norm(axis)
    a = deg2rad(angle)
    s, c = jnp.sin(a), jnp.cos(a)
    oc = 1.0 - c
    x, y, z = u[0], u[1], u[2]
    # Columns of the Fortran matrix become rows transposed: build M(i,j)
    # directly matching rotmat(:, j) assignments.
    m = jnp.array(
        [
            [oc * x * x + c, oc * x * y + z * s, oc * z * x - y * s, 0.0],
            [oc * x * y - z * s, oc * y * y + c, oc * y * z + x * s, 0.0],
            [oc * z * x + y * s, oc * y * z - x * s, oc * z * z + c, 0.0],
            [0.0, 0.0, 0.0, 1.0],
        ],
        dtype=u.dtype,
    )
    return m


def skew_symm(a: jnp.ndarray) -> jnp.ndarray:
    """Skew symmetric matrix of a vector (sdfHelpers.f90:155-167)."""
    a = jnp.asarray(a)
    x, y, z = a[0], a[1], a[2]
    zero = jnp.zeros_like(x)
    return jnp.stack(
        [
            jnp.stack([zero, z, -y, zero]),
            jnp.stack([-z, zero, x, zero]),
            jnp.stack([y, -x, zero, zero]),
            jnp.stack([zero, zero, zero, zero]),
        ]
    )


def rotation_align(a: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    """Rodrigues rotation aligning unit vector ``a`` onto ``b``
    (sdfHelpers.f90:114-140).  Undefined for ``a == -b`` like the reference.
    """
    a = jnp.asarray(a)
    b = jnp.asarray(b)
    v = jnp.cross(a, b)
    c = jnp.sum(a * b)
    k = 1.0 / (1.0 + c)
    vx = skew_symm(v)
    return jnp.eye(4, dtype=a.dtype) + vx + matmul(vx, vx) * k


def matmul(a: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    """Matrix product at full f32 precision (default precision may
    round f32 operands to TF32 on tensor cores)."""
    return jnp.matmul(a, b, precision=jax.lax.Precision.HIGHEST)


def invert(m: jnp.ndarray) -> jnp.ndarray:
    """4x4 matrix inverse (reference: src/mat_class.f90:154-207)."""
    return jnp.linalg.inv(m)
