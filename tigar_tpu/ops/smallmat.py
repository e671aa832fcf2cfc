"""Closed-form determinants/inverses for 1x1..3x3 matrices.

Batched tiny LU is wasteful: every metric/Jacobian inverse in IGA is d x d
with d <= 3, so closed forms are simpler and faster.
"""

from __future__ import annotations

import jax.numpy as jnp


def det_small(A):
    """Determinant of a static-shape [n, n] matrix, n <= 3."""
    n = A.shape[-1]
    if n == 1:
        return A[..., 0, 0]
    if n == 2:
        return (A[..., 0, 0] * A[..., 1, 1]
                - A[..., 0, 1] * A[..., 1, 0])
    if n == 3:
        return (A[..., 0, 0] * (A[..., 1, 1] * A[..., 2, 2]
                                - A[..., 1, 2] * A[..., 2, 1])
                - A[..., 0, 1] * (A[..., 1, 0] * A[..., 2, 2]
                                  - A[..., 1, 2] * A[..., 2, 0])
                + A[..., 0, 2] * (A[..., 1, 0] * A[..., 2, 1]
                                  - A[..., 1, 1] * A[..., 2, 0]))
    raise ValueError("det_small supports n <= 3")


def inv_small(A, det=None):
    """Inverse of a static-shape [n, n] matrix, n <= 3 (adjugate formula)."""
    n = A.shape[-1]
    if det is None:
        det = det_small(A)
    if n == 1:
        return (1.0 / A[..., 0, 0])[..., None, None]
    if n == 2:
        adj = jnp.stack([
            jnp.stack([A[..., 1, 1], -A[..., 0, 1]], axis=-1),
            jnp.stack([-A[..., 1, 0], A[..., 0, 0]], axis=-1),
        ], axis=-2)
        return adj / det[..., None, None]
    if n == 3:
        c00 = A[..., 1, 1] * A[..., 2, 2] - A[..., 1, 2] * A[..., 2, 1]
        c01 = A[..., 0, 2] * A[..., 2, 1] - A[..., 0, 1] * A[..., 2, 2]
        c02 = A[..., 0, 1] * A[..., 1, 2] - A[..., 0, 2] * A[..., 1, 1]
        c10 = A[..., 1, 2] * A[..., 2, 0] - A[..., 1, 0] * A[..., 2, 2]
        c11 = A[..., 0, 0] * A[..., 2, 2] - A[..., 0, 2] * A[..., 2, 0]
        c12 = A[..., 0, 2] * A[..., 1, 0] - A[..., 0, 0] * A[..., 1, 2]
        c20 = A[..., 1, 0] * A[..., 2, 1] - A[..., 1, 1] * A[..., 2, 0]
        c21 = A[..., 0, 1] * A[..., 2, 0] - A[..., 0, 0] * A[..., 2, 1]
        c22 = A[..., 0, 0] * A[..., 1, 1] - A[..., 0, 1] * A[..., 1, 0]
        adj = jnp.stack([
            jnp.stack([c00, c01, c02], axis=-1),
            jnp.stack([c10, c11, c12], axis=-1),
            jnp.stack([c20, c21, c22], axis=-1),
        ], axis=-2)
        return adj / det[..., None, None]
    raise ValueError("inv_small supports n <= 3")
