"""f32 fast-path operator applies for generic element batches.

There is no hand-written kernel here.  An earlier measurement of a fused
hand kernel against the XLA einsum formulation of this apply found them
indistinguishable: the per-element GATHER of coefficients and the
SCATTER-ADD of results dominate, and a kernel cannot fix a data-movement
problem that sits outside it.  The structural fix is to eliminate
gather/scatter entirely, which the tensor-product sum-factorized
operators do with shifted-slice windows; they are the fast path for
tensor-product spaces (scalar: ops/sumfac.py; arbitrary forms and
multi-field: ops/sumfac_forms.py).  Whether a Hopper kernel pays for the
gather/scatter apply is an open, measured question.

This module keeps the XLA-fused element apply for spaces with EXPLICIT
element connectivity (multi-patch unions, T-splines with ragged nshl),
where windows do not exist and gather/scatter is inherent.  Compute dtype
is float32; pair with solvers/refinement.py for f64 accuracy.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp


def laplace_layouts(asm):
    """Precompute the (A1, A2) layouts of the fused stiffness apply for a
    scalar space: A1 = trial gradients, A2 = qw * sqrtJ * ginv-weighted test
    gradients.  One-time geometry work (f32).  Element-major (element axis
    last, riding the 128-wide vector lanes)."""
    if asm.nfields != 1:
        raise ValueError("fused Laplace apply expects a scalar space")
    dN = asm.dNs[0]                       # [nel, nq, nen, d]
    nel, nq, nen, d = dN.shape
    G = asm.ctx.ginv * asm.scale[..., None, None]   # [nel, nq, d, d]
    dNG = jnp.einsum("eqac,eqdc->eqad", dN, G)      # weighted test grads
    A1 = dN.transpose(2, 1, 3, 0).reshape(nen * nq * d, nel)
    A2 = dNG.transpose(2, 1, 3, 0).reshape(nen * nq * d, nel)
    return A1.astype(jnp.float32), A2.astype(jnp.float32)


@functools.partial(jax.jit, static_argnames=("ndof", "nen"))
def _laplace_apply(A1, A2, connT, mask, W, ndof, nen):
    Wm = (mask * W).astype(jnp.float32)
    ue = Wm[connT]
    m = A1.shape[0] // nen
    A1r = A1.reshape(nen, m, -1)
    A2r = A2.reshape(nen, m, -1)
    g = jnp.einsum("amn,an->mn", A1r, ue)
    re = jnp.einsum("amn,mn->an", A2r, g)
    r = jnp.zeros(ndof, dtype=jnp.float32).at[connT].add(re)
    return (mask * r + (1.0 - mask) * W).astype(W.dtype)


def make_laplace_operator(asm, mask):
    """Matrix-free f32 stiffness operator W -> A @ W for a scalar space
    with explicit element connectivity.  For tensor-product spaces use
    ops/sumfac.make_sumfac_operator instead (10x: see module docstring)."""
    A1, A2 = laplace_layouts(asm)
    connT = asm.conns[0].T  # [nen, nel]
    ndof = asm.ndof
    nen = int(connT.shape[0])

    def op(W):
        return _laplace_apply(A1, A2, connT, mask, W, ndof, nen)

    return op
