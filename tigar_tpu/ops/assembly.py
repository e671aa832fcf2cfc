"""Batched assembly over Bezier elements: residuals, tangents, matrices.

This replaces the reference's entire assembly stack -- FFC-generated element
kernels called by DOLFIN ``assemble``, the PETSc MatPtAP projection MᵀAM and
MᵀB extraction (tIGAr/common.py:1142-1234) -- with one batched pattern:

  gather DoFs -> evaluate field jets at quad points (batched einsum)
  -> vmapped pointwise density -> weighted sum / AD transpose -> scatter-add.

Residual vectors are reverse-mode gradients of the (linear-in-test-function)
total form; tangent actions are JVPs of the residual map; explicit matrices
come from per-element ``jacfwd`` + scatter.  Because fields are evaluated in
spline space directly, there is no extraction matrix and no PtAP: the
"extraction" is fused into the tabulated basis.

``DomainAssembler`` is registered as a JAX pytree so jitted kernels receive
its arrays as runtime arguments (not trace-embedded constants).  Densities
may take an optional trailing ``params`` pytree (traced; constant across
quadrature points) so load stepping and time stepping do not retrace.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from ..forms import Jet


def _vmap_density(density, params):
    """vmap a pointwise density over the quadrature axis of its jet/ctx
    arguments; ``params`` (if given) is broadcast unbatched."""
    if params is None:
        return jax.vmap(density)

    def wrapped(*args):
        axes = (0,) * len(args) + (None,)
        return jax.vmap(density, in_axes=axes)(*args, params)
    return wrapped


def _is_jet_tree(x):
    """True if ``x`` is already a Jet pytree (or dict of Jets), as produced
    by ``jets_tree`` -- as opposed to raw global DoF vectors."""
    if isinstance(x, Jet):
        return True
    if isinstance(x, dict):
        return any(isinstance(v, Jet) for v in x.values())
    return False


def _tree_local_jets(asm, Ue_e, Ns_e, dNs_e, d2Ns_e, masks_e):
    """Local jets of a tree of per-element coefficient vectors [nloc]."""
    return jax.tree_util.tree_map(
        lambda ue: asm._local_jets(ue, Ns_e, dNs_e, d2Ns_e, masks_e), Ue_e)


class DomainAssembler:
    """Assembly over one element batch (the volume, or one boundary side).

    Parameters
    ----------
    field_tabs : list of Tabulation, one per field (shared element grid)
    offsets    : [nfields+1] global DoF offsets
    ndof       : total DoFs
    ctx        : QP pytree with leaf leading dims [nel, nq]
    scale      : [nel, nq] quadrature weights * volume/surface Jacobian
    """

    def __init__(self, field_tabs, offsets, ndof, ctx, scale, chunk=None):
        self.nfields = len(field_tabs)
        self.offsets = tuple(int(o) for o in offsets)
        self.ndof = int(ndof)
        self.ctx = ctx
        self.scale = jnp.asarray(scale)
        self.chunk = None if chunk is None else int(chunk)
        self.conns = []
        self.Ns = []
        self.dNs = []
        self.d2Ns = []
        self.masks = []
        for t in field_tabs:
            self.conns.append(jnp.asarray(t.conn))
            self.Ns.append(jnp.asarray(t.N))
            self.dNs.append(None if t.dN is None else jnp.asarray(t.dN))
            self.d2Ns.append(None if t.d2N is None else jnp.asarray(t.d2N))
            self.masks.append(None if t.mask is None else jnp.asarray(t.mask))
        self.nens = tuple(t.nen for t in field_tabs)
        self.nloc = int(sum(self.nens))
        # concatenated element connectivity in global numbering
        self.cat_conn = jnp.concatenate(
            [self.conns[f] + self.offsets[f] for f in range(self.nfields)],
            axis=1)

    @property
    def nel(self):
        return self.scale.shape[0]

    @property
    def nq(self):
        return self.scale.shape[1]

    def astype(self, dtype):
        """Copy with all floating arrays cast to ``dtype`` -- the
        mixed-precision fast path (pair with solvers.refinement to recover
        f64 accuracy)."""
        import jax.tree_util as jtu
        children, aux = self.tree_flatten()
        children = jtu.tree_map(
            lambda x: x.astype(dtype)
            if hasattr(x, "dtype") and jnp.issubdtype(x.dtype, jnp.floating)
            else x, children)
        return type(self).tree_unflatten(aux, children)

    def with_chunk(self, chunk):
        """Copy sharing all arrays but with a different ``lax.map`` chunk
        size (static -- changes trigger a re-trace).  Memory-heavy element
        kernels (``element_matrices_adjoint``, especially in f64 where
        every intermediate doubles) need a smaller chunk than the
        residual default to bound HLO temps."""
        children, aux = self.tree_flatten()
        aux = aux[:-1] + (None if chunk is None else int(chunk),)
        return type(self).tree_unflatten(aux, children)

    # -- pytree protocol ---------------------------------------------------------

    def tree_flatten(self):
        children = (self.ctx, self.scale, tuple(self.conns), tuple(self.Ns),
                    tuple(self.dNs), tuple(self.d2Ns), tuple(self.masks),
                    self.cat_conn)
        aux = (self.nfields, self.offsets, self.ndof, self.nens, self.nloc,
               self.chunk)
        return children, aux

    @classmethod
    def tree_unflatten(cls, aux, children):
        obj = cls.__new__(cls)
        (obj.ctx, obj.scale, conns, Ns, dNs, d2Ns, masks,
         obj.cat_conn) = children
        obj.conns = list(conns)
        obj.Ns = list(Ns)
        obj.dNs = list(dNs)
        obj.d2Ns = list(d2Ns)
        obj.masks = list(masks)
        (obj.nfields, obj.offsets, obj.ndof, obj.nens, obj.nloc,
         obj.chunk) = aux
        return obj

    # -- field evaluation -------------------------------------------------------

    def _field_jet(self, f, ce):
        """Jets of field ``f`` from element coefficients ce [nel, nen_f]."""
        if self.masks[f] is not None:
            ce = ce * self.masks[f]
        val = jnp.einsum("eqa,ea->eq", self.Ns[f], ce)
        g = None if self.dNs[f] is None else jnp.einsum(
            "eqad,ea->eqd", self.dNs[f], ce)
        h = None if self.d2Ns[f] is None else jnp.einsum(
            "eqadc,ea->eqdc", self.d2Ns[f], ce)
        return val, g, h

    def jets(self, U):
        """Evaluate the multi-field jet arrays of global vector U.

        Scalar space: leaves [nel,nq], [nel,nq,d], [nel,nq,d,d].
        Vector space: leaves [nel,nq,nf], [nel,nq,nf,d], ...
        """
        vals, gs, hs = [], [], []
        for f in range(self.nfields):
            ce = U[self.offsets[f] + self.conns[f]]
            v, g, h = self._field_jet(f, ce)
            vals.append(v)
            gs.append(g)
            hs.append(h)
        if self.nfields == 1:
            return Jet(vals[0], gs[0], hs[0])
        val = jnp.stack(vals, axis=2)
        g = None if gs[0] is None else jnp.stack(gs, axis=2)
        h = None if hs[0] is None else jnp.stack(hs, axis=2)
        return Jet(val, g, h)

    def jets_tree(self, U):
        """jets() over an array or a dict of arrays."""
        if isinstance(U, dict):
            return {k: self.jets(jnp.asarray(v)) for k, v in U.items()}
        return self.jets(jnp.asarray(U))

    # -- element mapping (the memory-scaling knob) --------------------------------

    def _map_elements(self, fn, xs):
        """Apply a per-element function over the element batch.

        With ``chunk`` unset (or >= nel) this is one vmap -- maximal fusion,
        one XLA program.  With ``chunk`` set, elements are processed in
        chunks via ``lax.map(batch_size=chunk)``: peak memory for the
        per-point jet intermediates (which XLA pads heavily for small
        trailing dims, e.g. (d,d) Hessians) is bounded by one chunk instead
        of the whole batch.  This is what lets 256^2+ shell assembly fit a
        single chip (round-1 known limit; VERDICT item 2)."""
        if self.chunk is None or self.chunk >= self.nel:
            return jax.vmap(fn)(xs)
        return jax.lax.map(fn, xs, batch_size=self.chunk)

    def _elem_xs(self, Ue=None):
        base = (self.ctx, self.scale, tuple(self.Ns), tuple(self.dNs),
                tuple(self.d2Ns), tuple(self.masks))
        return base if Ue is None else (Ue,) + base

    def _gather_local(self, U):
        """Tree of global DoF vectors -> tree of [nel, nloc] element
        coefficients (concatenated over fields, global numbering)."""
        return jax.tree_util.tree_map(
            lambda u: jnp.asarray(u)[self.cat_conn], U)

    # -- global assembly --------------------------------------------------------

    def functional(self, density, u_jets=None, params=None):
        """Integrate density(ctx[, u][, params]) over the domain.
        ``u_jets``: global DoF vector / dict of vectors (jets are evaluated
        per element), or a precomputed jets tree from ``jets_tree``."""
        dtype = self.scale.dtype
        pre_jets = _is_jet_tree(u_jets)

        def elem(args):
            if u_jets is None:
                ctx_e, scale_e, Ns_e, dNs_e, d2Ns_e, masks_e = args
                dens = _vmap_density(density, params)(ctx_e)
            else:
                Ue_e, ctx_e, scale_e, Ns_e, dNs_e, d2Ns_e, masks_e = args
                if pre_jets:
                    uj = Ue_e
                else:
                    uj = _tree_local_jets(self, Ue_e, Ns_e, dNs_e, d2Ns_e,
                                          masks_e)
                dens = _vmap_density(density, params)(ctx_e, uj)
            return jnp.sum(dens * scale_e)

        if u_jets is None:
            xs = self._elem_xs()
        elif pre_jets:
            xs = self._elem_xs(u_jets)
        else:
            xs = self._elem_xs(self._gather_local(u_jets))
        return jnp.sum(self._map_elements(elem, xs)).astype(dtype)

    def element_residuals(self, density, U=None, params=None):
        """[nel, nloc] element residual contributions: the gradient of the
        elementwise form w.r.t. the local test coefficients.  ``U`` is a
        global DoF vector or dict of vectors (unknown and auxiliary fields);
        field jets are evaluated from gathered element coefficients, so no
        [nel, nq, ...] jet array is ever materialized globally."""
        dtype = self.scale.dtype

        def elem(args):
            if U is None:
                ctx_e, scale_e, Ns_e, dNs_e, d2Ns_e, masks_e = args
            else:
                Ue_e, ctx_e, scale_e, Ns_e, dNs_e, d2Ns_e, masks_e = args
                uj = _tree_local_jets(self, Ue_e, Ns_e, dNs_e, d2Ns_e,
                                      masks_e)

            def R(vloc):
                v = self._local_jets(vloc, Ns_e, dNs_e, d2Ns_e, masks_e)
                if U is None:
                    dens = _vmap_density(density, params)(ctx_e, v)
                else:
                    dens = _vmap_density(density, params)(ctx_e, uj, v)
                return jnp.sum(dens * scale_e)

            return jax.grad(R)(jnp.zeros(self.nloc, dtype=dtype))

        xs = self._elem_xs(None if U is None else self._gather_local(U))
        return self._map_elements(elem, xs)

    def scatter_vector(self, r_e):
        """Scatter-add [nel, nloc] element vectors into a global vector."""
        out = jnp.zeros(self.ndof, dtype=r_e.dtype)
        return out.at[self.cat_conn].add(r_e)

    def linear_vector(self, density, params=None):
        """Assemble b_i = L(N_i) for density(ctx, v[, params]) linear in v."""
        return self.scatter_vector(
            self.element_residuals(density, U=None, params=params))

    def residual_vector(self, density, U, params=None):
        """Assemble r_i = res(u; N_i) for density(ctx, u, v[, params]) linear
        in v.  ``U``: global DoF vector or dict of vectors."""
        return self.scatter_vector(
            self.element_residuals(density, U, params=params))

    # -- adjoint-form assembly (no assembly-level AD) ----------------------------

    def _contract_adjoint(self, F, scale_e, Ns_e, dNs_e, d2Ns_e, masks_e):
        """Transpose of ``_local_jets``: contract a weighted adjoint jet
        F (leaves [nq, ...]) with the tabulations -> local vector [nloc]."""
        parts = []
        for f in range(self.nfields):
            if self.nfields == 1:
                Fval, Fg, Fh = F.val, F.g, F.h
            else:
                Fval = None if F.val is None else F.val[:, f]
                Fg = None if F.g is None else F.g[:, f]
                Fh = None if F.h is None else F.h[:, f]
            r = jnp.zeros(Ns_e[f].shape[1], dtype=scale_e.dtype)
            if Fval is not None:
                r = r + jnp.einsum("q,qa->a", scale_e * Fval, Ns_e[f])
            if Fg is not None and dNs_e[f] is not None:
                r = r + jnp.einsum("qd,qad->a", scale_e[:, None] * Fg,
                                   dNs_e[f])
            if Fh is not None and d2Ns_e[f] is not None:
                r = r + jnp.einsum("qdc,qadc->a",
                                   scale_e[:, None, None] * Fh, d2Ns_e[f])
            if masks_e[f] is not None:
                r = r * masks_e[f]
            parts.append(r)
        return jnp.concatenate(parts)

    def element_residuals_adjoint(self, adjoint_density, U, params=None):
        """[nel, nloc] element residuals WITHOUT assembly-level AD.

        ``adjoint_density(ctx, u[, params])`` returns the ADJOINT JET
        F = (Fval, Fg, Fh) of the residual density with respect to the test
        jet: res(ctx, u, v) == sum(Fval*v.val) + sum(Fg*v.g) + sum(Fh*v.h).
        Assembly is then a pure einsum contraction with the tabulations (the
        exact transpose of the jet evaluation) -- no reverse-mode AD in the
        element kernel.  This is the fast path for f64 assembly, where
        the reverse sweep through a pointwise density generates far more
        code than the explicit adjoint
        (models/shell.svk_shell_adjoint; forms.adjoint_of for the generic
        AD-at-a-point fallback)."""
        def elem(args):
            Ue_e, ctx_e, scale_e, Ns_e, dNs_e, d2Ns_e, masks_e = args
            uj = _tree_local_jets(self, Ue_e, Ns_e, dNs_e, d2Ns_e, masks_e)
            F = _vmap_density(adjoint_density, params)(ctx_e, uj)
            return self._contract_adjoint(F, scale_e, Ns_e, dNs_e, d2Ns_e,
                                          masks_e)

        xs = self._elem_xs(self._gather_local(U))
        return self._map_elements(elem, xs)

    def residual_vector_adjoint(self, adjoint_density, U, params=None):
        """Assembled residual from an adjoint-jet density (see
        ``element_residuals_adjoint``)."""
        return self.scatter_vector(
            self.element_residuals_adjoint(adjoint_density, U,
                                           params=params))

    def element_matrices_adjoint(self, adjoint_density, U, params=None):
        """[nel, nloc, nloc] element tangent matrices via the POINTWISE
        jet-Hessian of an adjoint-jet density (see
        ``element_residuals_adjoint``): forward-mode AD stays at the
        quadrature point over the small jet vector (dim J ~ nf*(1+d+d^2)),
        and the local matrices come out as two batched contractions

            K[q] = d(F_flat)/d(u_flat)   [J, J]   (jacfwd, J directions)
            E    = sum_q w_q B[q]^T K[q] B[q],    B[q] = d(u_flat)/d(uloc)

        versus ``element_matrices``'s nested reverse-over-forward AD over
        the nloc-dim local space.  B is the exact linearization of the
        (linear) local jet evaluation, so E is exact."""
        from jax.flatten_util import ravel_pytree

        dtype = self.scale.dtype
        is_dict = isinstance(U, dict)

        def elem(args):
            Ue_e, ctx_e, scale_e, Ns_e, dNs_e, d2Ns_e, masks_e = args
            uloc = Ue_e["u"] if is_dict else Ue_e
            uj = self._local_jets(uloc, Ns_e, dNs_e, d2Ns_e, masks_e)
            u0 = jax.tree_util.tree_map(lambda x: x[0], uj)
            _, unravel = ravel_pytree(u0)

            def flat_jets(ul):
                jets = self._local_jets(ul, Ns_e, dNs_e, d2Ns_e, masks_e)
                return jax.vmap(lambda *ls: ravel_pytree(
                    jax.tree_util.tree_unflatten(
                        jax.tree_util.tree_structure(u0), ls))[0])(
                    *jax.tree_util.tree_leaves(jets))

            B = jax.jacfwd(flat_jets)(jnp.zeros(self.nloc, dtype=dtype))

            aux = {k: self._local_jets(v, Ns_e, dNs_e, d2Ns_e, masks_e)
                   for k, v in Ue_e.items() if k != "u"} if is_dict else {}

            def point_F(u_flat, ctx_q, aux_q):
                u = unravel(u_flat)
                uu = {"u": u, **aux_q} if is_dict else u
                if params is None:
                    F = adjoint_density(ctx_q, uu)
                else:
                    F = adjoint_density(ctx_q, uu, params)
                return ravel_pytree(F)[0]

            u_flat = flat_jets(uloc)
            K = jax.vmap(jax.jacfwd(point_F))(u_flat, ctx_e, aux)
            KB = jnp.einsum("qJK,qKb->qJb", K, B)
            return jnp.einsum("qJa,qJb,q->ab", B, KB, scale_e)

        xs = self._elem_xs(self._gather_local(U))
        return self._map_elements(elem, xs)

    def element_matrices_hessian(self, hessian_density, U, params=None):
        """[nel, nloc, nloc] element tangent matrices from a CLOSED-FORM
        pointwise jet-Hessian density: ``hessian_density(ctx, u[, params])``
        returns K [J, J] with J the flattened-jet dimension (Jet ravel
        order), such that for any test/trial jets v, w

            d2(density)(u; v, w) == ravel(v) @ K @ ravel(w).

        Identical contraction structure to ``element_matrices_adjoint``
        (E = sum_q w_q B^T K B) but with the jacfwd sweep over the J jet
        directions replaced by ONE evaluation of the hand-derived Hessian
        -- the fast build path for densities with a known second
        variation (models/shell.svk_shell_hessian cuts the dominant
        tangent-stencil build term of the production Newton step)."""
        from jax.flatten_util import ravel_pytree

        dtype = self.scale.dtype
        is_dict = isinstance(U, dict)

        def elem(args):
            Ue_e, ctx_e, scale_e, Ns_e, dNs_e, d2Ns_e, masks_e = args
            uloc = Ue_e["u"] if is_dict else Ue_e
            uj = self._local_jets(uloc, Ns_e, dNs_e, d2Ns_e, masks_e)
            u0 = jax.tree_util.tree_map(lambda x: x[0], uj)
            _, unravel = ravel_pytree(u0)

            def flat_jets(ul):
                jets = self._local_jets(ul, Ns_e, dNs_e, d2Ns_e, masks_e)
                return jax.vmap(lambda *ls: ravel_pytree(
                    jax.tree_util.tree_unflatten(
                        jax.tree_util.tree_structure(u0), ls))[0])(
                    *jax.tree_util.tree_leaves(jets))

            B = jax.jacfwd(flat_jets)(jnp.zeros(self.nloc, dtype=dtype))
            aux = {k: self._local_jets(v, Ns_e, dNs_e, d2Ns_e, masks_e)
                   for k, v in Ue_e.items() if k != "u"} if is_dict else {}

            def point_K(u_flat, ctx_q, aux_q):
                u = unravel(u_flat)
                uu = {"u": u, **aux_q} if is_dict else u
                if params is None:
                    return hessian_density(ctx_q, uu)
                return hessian_density(ctx_q, uu, params)

            K = jax.vmap(point_K)(flat_jets(uloc), ctx_e, aux)
            KB = jnp.einsum("qJK,qKb->qJb", K, B)
            return jnp.einsum("qJa,qJb,q->ab", B, KB, scale_e)

        xs = self._elem_xs(self._gather_local(U))
        return self._map_elements(elem, xs)

    # -- per-element explicit matrices ------------------------------------------

    def _split_local(self, uloc):
        parts = []
        s = 0
        for f in range(self.nfields):
            parts.append(uloc[s:s + self.nens[f]])
            s += self.nens[f]
        return parts

    def _local_jets(self, uloc, Ns_e, dNs_e, d2Ns_e, masks_e):
        parts = self._split_local(uloc)
        vals, gs, hs = [], [], []
        for f in range(self.nfields):
            ce = parts[f]
            if masks_e[f] is not None:
                ce = ce * masks_e[f]
            vals.append(jnp.einsum("qa,a->q", Ns_e[f], ce))
            gs.append(None if dNs_e[f] is None else
                      jnp.einsum("qad,a->qd", dNs_e[f], ce))
            hs.append(None if d2Ns_e[f] is None else
                      jnp.einsum("qadc,a->qdc", d2Ns_e[f], ce))
        if self.nfields == 1:
            return Jet(vals[0], gs[0], hs[0])
        val = jnp.stack(vals, axis=1)
        g = None if gs[0] is None else jnp.stack(gs, axis=1)
        h = None if hs[0] is None else jnp.stack(hs, axis=1)
        return Jet(val, g, h)

    def element_matrices(self, density, U, params=None):
        """[nel, nloc, nloc] element tangent matrices of density(ctx, u, v),
        linearized about U, via nested AD (jacfwd of the local residual).

        ``U``: global DoF vector, or a dict with the unknown under "u" and
        auxiliary known fields alongside (linearization is w.r.t. "u" only).
        """
        dtype = self.scale.dtype
        is_dict = isinstance(U, dict)

        def elem(args):
            Ue_e, ctx_e, scale_e, Ns_e, dNs_e, d2Ns_e, masks_e = args

            def local_residual(ul):
                def R(vloc):
                    uj = self._local_jets(ul, Ns_e, dNs_e, d2Ns_e, masks_e)
                    if is_dict:
                        aux = {k: self._local_jets(v, Ns_e, dNs_e, d2Ns_e,
                                                   masks_e)
                               for k, v in Ue_e.items() if k != "u"}
                        u = {"u": uj, **aux}
                    else:
                        u = uj
                    v = self._local_jets(vloc, Ns_e, dNs_e, d2Ns_e, masks_e)
                    dens = _vmap_density(density, params)(ctx_e, u, v)
                    return jnp.sum(dens * scale_e)
                return jax.grad(R)(jnp.zeros(self.nloc, dtype=dtype))

            uloc = Ue_e["u"] if is_dict else Ue_e
            return jax.jacfwd(local_residual)(uloc)

        xs = self._elem_xs(self._gather_local(U))
        return self._map_elements(elem, xs)

    def scatter_dense(self, A_e):
        """Scatter element matrices into a dense [ndof, ndof] matrix."""
        rows = self.cat_conn[:, :, None]
        cols = self.cat_conn[:, None, :]
        A = jnp.zeros((self.ndof, self.ndof), dtype=A_e.dtype)
        return A.at[rows, cols].add(A_e)

    def scatter_diag(self, A_e):
        """Scatter only the element-matrix diagonals (Jacobi preconditioner)."""
        d = jnp.diagonal(A_e, axis1=1, axis2=2)
        out = jnp.zeros(self.ndof, dtype=A_e.dtype)
        return out.at[self.cat_conn].add(d)


jax.tree_util.register_pytree_node(
    DomainAssembler,
    lambda a: a.tree_flatten(),
    DomainAssembler.tree_unflatten)


def apply_bc_vector(b, mask):
    """Zero constrained entries of an assembled vector
    (reference: extractVector BC zeroing, common.py:1142-1160)."""
    return b * mask


def apply_bc_matrix(A, mask, diag=1.0):
    """Zero constrained rows/columns and set the diagonal
    (reference: zeroRowsColumns with ``diag`` knob, common.py:1197-1200;
    the large-diag variant shifts BC modes in eigenproblems,
    modal-analysis.py:66-69)."""
    A = A * mask[:, None] * mask[None, :]
    return A + jnp.diag(diag * (1.0 - mask))


def bc_operator(action, mask, diag=1.0):
    """Matrix-free version of apply_bc_matrix for an operator W -> A@W."""
    def op(w):
        return mask * action(mask * w) + diag * (1.0 - mask) * w
    return op


def scatter_bcoo(asm, A_e, ndof=None):
    """Assemble element matrices into a jax.experimental.sparse BCOO matrix
    (duplicates summed) -- the explicit-operator path for problems too large
    for dense assembly but needing an assembled matrix (cheap repeated
    matvecs, eigenproblems, preconditioner construction).  This replaces
    the reference's PETSc MPIAIJ + MatPtAP product (SURVEY.md section 7,
    hard part 4)."""
    from jax.experimental import sparse as jsparse
    import jax.numpy as jnp_

    ndof = asm.ndof if ndof is None else ndof
    nel, nloc, _ = A_e.shape
    rows = jnp_.broadcast_to(asm.cat_conn[:, :, None],
                             (nel, nloc, nloc)).reshape(-1)
    cols = jnp_.broadcast_to(asm.cat_conn[:, None, :],
                             (nel, nloc, nloc)).reshape(-1)
    idx = jnp_.stack([rows, cols], axis=1).astype(jnp_.int32)
    M = jsparse.BCOO((A_e.reshape(-1), idx), shape=(ndof, ndof))
    return M.sum_duplicates(nse=nel * nloc * nloc)
