"""Nonlocal (self-)contact via pointwise penalty forces.

Counterpart of the reef-knot demo's extra-UFL contact assembly
(demos/kl-shell-svk/reef-knot.py:100-269): collocation points carrying
lumped quadrature weights interact through a pair penalty potential
phi(r) = k/2 (r_max - r)^2 for r < r_max, with pairs closer than R_self in
the REFERENCE configuration excluded (self-contact exclusion,
reef-knot.py:148-152, 206-214).

Re-design: the reference finds pairs with a scipy cKDTree and
writes forces/tangents into PETSc objects entry by entry (explicitly noted
as serial-only, reef-knot.py:35-37).  Here interactions are evaluated as an
ALL-PAIRS masked distance computation -- static shapes, batched,
O(n^2) but far faster than tree construction for the n <= O(10^4)
collocation sets these problems use -- and forces/tangents come from AD of
the total pair energy through the spline point-evaluation operator, so they
are exactly consistent (the reference hand-codes its (24)-(26) formulas).
"""

from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp

from .config import INDEX_TYPE


def pair_penalty_energy(k, r_max):
    """phi(r) = k/2 (r_max - r)^2 for r < r_max, else 0 -- the linear
    penalty force of reef-knot.py:131-138."""
    def phi(r):
        return jnp.where(r < r_max, 0.5 * k * (r_max - r) ** 2, 0.0)
    return phi


class PointContact:
    """Penalty contact between collocation points of an equal-order
    displacement spline (nsd-vector field sharing the control basis).

    Collocation points are the Greville abscissae of the displacement basis
    with lumped-mass quadrature weights (the analog of the reference's
    FE-node quadrature, reef-knot.py:139-146).
    """

    def __init__(self, spline, k, r_max, r_self, phi=None, row_chunk=None):
        """``row_chunk``: process the all-pairs interaction in row blocks of
        this size (lax.map + rematerialization), bounding peak memory to
        O(row_chunk * n) instead of O(n^2) -- the scaling knob for the
        reference workload class of ~10^4 collocation points
        (reef-knot.py:157-269).  Default: 2048 rows when n > 4096."""
        self.spline = spline
        self.r_max = float(r_max)
        self.r_self = float(r_self)
        self.phi = pair_penalty_energy(k, r_max) if phi is None else phi
        self.row_chunk = row_chunk

        space = spline.space
        basis = space.fields[0]
        for f in space.fields:
            if f is not basis:
                raise ValueError("PointContact requires an equal-order space")
        self.nsd = space.nsd
        if space.nfields != self.nsd:
            raise ValueError("displacement space must have nsd fields")

        # collocation points: Greville abscissae
        gp = basis.greville_points()           # [n, dim]
        n = gp.shape[0]

        # point-evaluation operator: for Greville point i, the supported
        # basis functions and their values (a sparse row of the evaluation
        # matrix, stored as gather indices + weights)
        from .ops.basis import eval_basis
        if not hasattr(basis, "kvs"):
            raise NotImplementedError("PointContact currently supports "
                                      "tensor-product displacement bases")
        nodes_d, vals_d = [], []
        for d, kv in enumerate(basis.kvs):
            nd, ders = eval_basis(kv, gp[:, d], 0)
            nodes_d.append(nd)
            vals_d.append(ders[:, 0, :])
        conn = nodes_d[0]
        vals = vals_d[0]
        stride = basis.kvs[0].ncp
        for d in range(1, basis.dim):
            conn = (conn[:, :, None]
                    + stride * nodes_d[d][:, None, :]).reshape(n, -1)
            vals = (vals[:, :, None] * vals_d[d][:, None, :]).reshape(n, -1)
            stride *= basis.kvs[d].ncp
        self.conn = jnp.asarray(conn.astype(INDEX_TYPE))
        self.vals = jnp.asarray(vals, dtype=spline.dtype)

        # control weights at collocation points (homogeneous -> physical)
        bnet = np.asarray(spline.bnet)
        wts = basis.evaluate(bnet[:, -1], gp)
        Xh = np.stack([basis.evaluate(bnet[:, j], gp)
                       for j in range(self.nsd)], axis=-1)
        self.X = jnp.asarray(Xh / wts[:, None], dtype=spline.dtype)
        self.w_ctrl = jnp.asarray(wts, dtype=spline.dtype)

        # lumped quadrature weights: integral of each (rationalized) basis
        # function (reference: W = assemble(inner(1, v) dx),
        # reef-knot.py:139-146)
        def Lones(ctx, v):
            return jnp.sum(jnp.atleast_1d(ctx.rationalize(v).val))
        W = spline.assemble_vector(Lones, apply_bcs=False)
        self.quad_w = W[space.field_slice(0)]

        # static reference-distance exclusion mask (R_self and self-pairs),
        # stored as bool (n^2 bytes, not n^2 doubles) and computed in row
        # blocks so the f64 distance transient stays O(block * n), not
        # O(n^2) (~740 MB at the reef demo's 9604 points)
        Xn = np.asarray(self.X)
        mask = np.empty((n, n), dtype=bool)
        blk = max(1, min(n, (1 << 22) // max(n, 1)))  # ~32 MB f64 transient
        for i0 in range(0, n, blk):
            d2 = np.sum((Xn[i0:i0 + blk, None, :] - Xn[None, :, :]) ** 2,
                        axis=-1)
            mask[i0:i0 + blk] = d2 > self.r_self ** 2
        self.pair_mask = jnp.asarray(mask)

        if self.row_chunk is None and n > 4096:
            self.row_chunk = 2048

        self._offsets = [int(space.offsets[f]) for f in range(self.nsd)]

    # -- kinematics -----------------------------------------------------------------

    def positions(self, U):
        """Deformed collocation-point positions x = X + disp(U)."""
        disp = []
        for j in range(self.nsd):
            cf = U[self._offsets[j] + self.conn]
            disp.append(jnp.einsum("na,na->n", self.vals, cf) / self.w_ctrl)
        return self.X + jnp.stack(disp, axis=-1)

    # -- energy / residual / tangent --------------------------------------------------

    def energy(self, U):
        x = self.positions(U)
        dtype = x.dtype
        n = x.shape[0]

        def row_energy(args):
            """Pair energy of one collocation point against all points."""
            xi, wi, mi = args  # [nsd], [], [n] bool
            diff = xi[None, :] - x
            r2 = jnp.sum(diff * diff, axis=-1)
            # keep sqrt differentiable: masked entries get a dummy distance
            safe = jnp.where(mi, r2, 1.0 + self.r_max ** 2)
            r = jnp.sqrt(safe)
            live = mi.astype(dtype)
            return 0.5 * wi * jnp.sum(live * self.quad_w * self.phi(r))

        xs = (x, self.quad_w, self.pair_mask)
        chunk = self.row_chunk
        if chunk is None or chunk >= n:
            parts = jax.vmap(row_energy)(xs)
        else:
            # row-blocked with rematerialization: peak memory O(chunk * n)
            parts = jax.lax.map(jax.checkpoint(row_energy), xs,
                                batch_size=chunk)
        return jnp.sum(parts)

    def residual(self, U):
        """Contact contribution to the residual (gradient of the energy) --
        the AD-exact analog of reef-knot.py's (24) force assembly.
        Jit-compiled with ``self`` as a pytree argument (arrays are runtime
        buffers, never trace-embedded constants)."""
        return _contact_residual(self, U)

    def tangent_action(self, U, W):
        """Action of the contact tangent (reference formulas (25)-(26),
        reef-knot.py:241-265) via HVP; jit-compiled."""
        return _contact_tangent(self, U, W)

    # -- pytree protocol ---------------------------------------------------------

    def tree_flatten(self):
        children = (self.conn, self.vals, self.X, self.w_ctrl, self.quad_w,
                    self.pair_mask)
        aux = (self.spline, self.phi, self.r_max, self.r_self,
               self.row_chunk, self.nsd, tuple(self._offsets))
        return children, aux

    @classmethod
    def tree_unflatten(cls, aux, children):
        obj = cls.__new__(cls)
        (obj.conn, obj.vals, obj.X, obj.w_ctrl, obj.quad_w,
         obj.pair_mask) = children
        (obj.spline, obj.phi, obj.r_max, obj.r_self, obj.row_chunk,
         obj.nsd, offsets) = aux
        obj._offsets = list(offsets)
        return obj


jax.tree_util.register_pytree_node(
    PointContact,
    lambda c: c.tree_flatten(),
    PointContact.tree_unflatten)


@jax.jit
def _contact_residual(contact, U):
    return jax.grad(contact.energy)(U)


@jax.jit
def _contact_tangent(contact, U, W):
    return jax.jvp(lambda a: jax.grad(contact.energy)(a), (U,), (W,))[1]
