"""Mixed-precision stencil-multigrid Newton for MULTI-PATCH spaces.

Round-3 VERDICT item #2: the production mixed-precision solver
(solvers/newton_stencil.StencilNewton) served exactly one space family --
equal-order single-patch tensor-product.  This module extends the SAME
solver structure (f32 production steps, stencil tangents, fused MG-CG,
f64/mixed polish to the double-precision evaluation floor) to equal-order
spaces over a MultiPatchBSplineBasis whose patches are weakly coupled by
ANY NUMBER of interface forms (penalty, or the round-4 consistent
interface.EnergyNitscheCoupling) -- arbitrary patch counts with one form
per interface, the round-4 VERDICT item #2 generalization (reference:
any number of Hughes-format patches, tIGAr/BSplines.py:967-1081, solved
space-agnostically, common.py:1304-1348):

  - the assembled tangent is a ``MultiPatchStencilOperator``: one
    sliding-window stencil PER PATCH (the element batch of a multipatch
    tabulation is the patch-ordered concatenation of per-patch batches,
    models/multipatch._concat_tabs, so per-patch element-matrix slices
    feed ops/stencil.stencil_from_element_matrices unchanged) plus one
    EXACT dense interface tangent block PER INTERFACE FORM from
    interface.InterfaceForm.tangent_block (per-quadrature-point
    jet-Hessians scattered over the interface support -- never an
    ndof-direction AD sweep);
  - level transfers are per-patch separable knot insertions
    (``MultiPatchProlong``), dropping into the SAME fused MG-CG programs
    as the single-patch solver through the up()/down() prolongation
    interface;
  - every level operator (smoothing residuals, Jacobi diagonals, the
    coarsest dense inverse) INCLUDES its level's interface blocks --
    penalty/Nitsche interface stiffness is comparable to the bending
    diagonal at production scales, so leaving it out of the smoother
    diverges the V-cycle on interface DoFs.  The V-cycle smoother applies
    one exact dense subspace (Schwarz) correction per interface block,
    MULTIPLICATIVELY across blocks (the residual is refreshed between
    blocks, so patches meeting at a corner -- where two interface
    supports share DoFs -- are not double-corrected);
  - the nonlinear residual is domain + sum of couplings:  r(U) =
    mask * (R(U) + sum_k dE_k/dU), assembled in f32 for production steps
    and in f64 (optionally native IEEE f64 on the host CPU backend) for
    the polish phase, with the same cross-backend evaluation-floor
    certificate.

CHECKED INPUT: all patches must share polynomial degrees.  Ragged-degree
multipatch tabulations are padded to the largest local basis and the
padded element-matrix slices do not feed stencil_from_element_matrices;
ragged-degree spaces are served by the space-agnostic SANewton tier
(solvers/newton_sa).
"""

from __future__ import annotations

from typing import Any, NamedTuple, Optional

import numpy as np
import jax
import jax.numpy as jnp

from .multigrid import insertion_matrix_1d
from .newton_stencil import (StencilNewton, make_stencil_mgcg,
                             make_stencil_mgcg_mixed, _grid_prolong,
                             _equal_order_basis)
from ..ops.stencil import (StencilOperator, stencil_from_element_matrices,
                           stencil_to_dense)
from ..ops.assembly import apply_bc_matrix
from ..interface import _iform_tangent_block


class IfaceBlock(NamedTuple):
    """One interface's dense tangent data inside a multipatch operator.

    idx  : [m] sorted global DoF indices of the interface support
    K    : [m, m] exact dense interface tangent block
    Sinv : [m, m] f32 dense inverse of the BC'd LOCAL interface operator
           (patch-stencil + other-block diagonals at idx, plus the full
           K): the exact subspace (Schwarz) correction the V-cycle
           smoother applies -- Jacobi alone cannot smooth the
           penalty-stiff interface block (measured: inner MG-CG stalls at
           0.31 relative without it).  None on f64 operator builds
           (preconditioning is always f32)."""
    idx: Any
    K: Any
    Sinv: Optional[Any] = None


class MultiPatchStencilOperator:
    """W -> A @ W for a multi-patch assembled tangent: block-diagonal
    per-patch StencilOperators (field-major global DoF layout, patch
    blocks contiguous within each field) plus one dense interface
    coupling block per interface form, each over that interface's
    supported DoFs.  Registered pytree; jit-stable across rebuilt
    values."""

    def __init__(self, sts, ifaces, foffsets, doffsets, nf):
        self.sts = tuple(sts)
        self.ifaces = tuple(ifaces)         # tuple of IfaceBlock
        self.foffsets = tuple(int(o) for o in foffsets)   # len nf
        self.doffsets = tuple(int(o) for o in doffsets)   # len n_patch+1
        self.nf = int(nf)

    @property
    def has_schwarz(self):
        return any(blk.Sinv is not None for blk in self.ifaces)

    def schwarz(self, r, mask):
        """Exact interface-subspace corrections (f32 local solves), one
        per interface block, applied MULTIPLICATIVELY: the residual is
        refreshed (one full BC'd operator apply) between blocks, so DoFs
        shared by two interface supports -- patches meeting at a corner
        -- are not double-corrected.  With a single interface this is
        exactly the round-4 correction (no extra applies).

        Each Sinv is a HOST-f64 inverse cast to f32 (see
        MultiPatchStencilNewton._mp_build: an f32 inverse of a
        penalty-dominated block is beyond Newton-Schulz repair).
        precision=HIGHEST on the apply: the block spans the penalty scales
        (pd ~ 2e9 displacement / pr ~ 2e6 rotation vs O(1e7) bending
        diagonal) and a reduced-precision (bf16/TF32) correction
        re-injects that format's relative noise on the stiffest rows.
        The op is [m, m] @ [m] with m ~ O(1e2-1e3)."""
        c = None
        for blk in self.ifaces:
            if blk.Sinv is None:
                continue
            rk = r if c is None else r - mask * self(mask * c)
            m_idx = mask[blk.idx]
            rs = (m_idx * rk[blk.idx]).astype(blk.Sinv.dtype)
            y = jnp.matmul(blk.Sinv, rs,
                           precision=jax.lax.Precision.HIGHEST
                           ).astype(r.dtype)
            corr = jnp.zeros_like(r).at[blk.idx].add(m_idx * y)
            c = corr if c is None else c + corr
        return jnp.zeros_like(r) if c is None else c

    @property
    def ndof(self):
        return self.nf * self.doffsets[-1]

    def _patch_block(self, U, p):
        dp = self.doffsets[p]
        ncp = self.doffsets[p + 1] - dp
        return jnp.concatenate([U[of + dp:of + dp + ncp]
                                for of in self.foffsets])

    def _scatter_patch(self, out, y, p):
        dp = self.doffsets[p]
        ncp = self.doffsets[p + 1] - dp
        y = y.reshape(self.nf, ncp)
        for f, of in enumerate(self.foffsets):
            out = out.at[of + dp:of + dp + ncp].set(y[f])
        return out

    def __call__(self, U):
        out = jnp.zeros_like(U)
        for p, st in enumerate(self.sts):
            out = self._scatter_patch(out, st(self._patch_block(U, p)), p)
        for blk in self.ifaces:
            # one dense GEMV per interface block, both dtypes;
            # precision=HIGHEST: penalty-scaled block (see schwarz()) --
            # reduced-precision products put their relative noise on
            # pd~2e9 entries, which the f32 production CG and V-cycle
            # smoothing residuals cannot tolerate
            y = jnp.matmul(blk.K, U[blk.idx],
                           precision=jax.lax.Precision.HIGHEST)
            out = out.at[blk.idx].add(y)
        return out

    def diagonal(self):
        n = self.ndof
        d = jnp.zeros((n,), dtype=self.sts[0].S.dtype)
        for p, st in enumerate(self.sts):
            d = self._scatter_patch(d, st.diagonal(), p)
        for blk in self.ifaces:
            d = d.at[blk.idx].add(jnp.diagonal(blk.K))
        return d

    def astype(self, dtype):
        return MultiPatchStencilOperator(
            tuple(st.astype(dtype) for st in self.sts),
            tuple(IfaceBlock(blk.idx, blk.K.astype(dtype), blk.Sinv)
                  for blk in self.ifaces),   # Sinv preconditioner-only,
            self.foffsets, self.doffsets, self.nf)         # stays f32

    def tree_flatten(self):
        return ((self.sts, self.ifaces),
                (self.foffsets, self.doffsets, self.nf))

    @classmethod
    def tree_unflatten(cls, aux, children):
        obj = cls.__new__(cls)
        obj.sts, obj.ifaces = children
        obj.foffsets, obj.doffsets, obj.nf = aux
        return obj


jax.tree_util.register_pytree_node(
    MultiPatchStencilOperator,
    lambda s: s.tree_flatten(),
    MultiPatchStencilOperator.tree_unflatten)


class MultiPatchProlong:
    """Per-patch separable knot-insertion prolongation between two
    multi-patch levels with identical patch layouts (pytree; the up/down
    interface of newton_stencil.TensorProlong)."""

    def __init__(self, Ps, nf, shapes_f, shapes_c, foff_f, foff_c,
                 doff_f, doff_c):
        self.Ps = tuple(tuple(p) for p in Ps)   # [patch][direction]
        self.nf = int(nf)
        self.shapes_f = tuple(tuple(s) for s in shapes_f)
        self.shapes_c = tuple(tuple(s) for s in shapes_c)
        self.foff_f = tuple(int(o) for o in foff_f)
        self.foff_c = tuple(int(o) for o in foff_c)
        self.doff_f = tuple(int(o) for o in doff_f)
        self.doff_c = tuple(int(o) for o in doff_c)

    def _move(self, x, Ps_by_patch, shapes_in, foff_in, doff_in,
              foff_out, doff_out, n_out, shapes_out):
        out = jnp.zeros((self.nf * doff_out[-1],), dtype=x.dtype)
        for p, Ps in enumerate(Ps_by_patch):
            dpi = doff_in[p]
            ncpi = doff_in[p + 1] - dpi
            blk = jnp.concatenate([x[of + dpi:of + dpi + ncpi]
                                   for of in foff_in])
            y = _grid_prolong(Ps, blk, self.nf, shapes_in[p])
            ncpo = doff_out[p + 1] - doff_out[p]
            y = y.reshape(self.nf, ncpo)
            for f, of in enumerate(foff_out):
                out = out.at[of + doff_out[p]:
                             of + doff_out[p] + ncpo].set(y[f])
        return out

    def up(self, xc):
        return self._move(xc, self.Ps, self.shapes_c, self.foff_c,
                          self.doff_c, self.foff_f, self.doff_f,
                          None, self.shapes_f)

    def down(self, rf):
        PsT = tuple(tuple(P.T for P in Ps) for Ps in self.Ps)
        return self._move(rf, PsT, self.shapes_f, self.foff_f,
                          self.doff_f, self.foff_c, self.doff_c,
                          None, self.shapes_c)

    def tree_flatten(self):
        return ((self.Ps,), (self.nf, self.shapes_f, self.shapes_c,
                             self.foff_f, self.foff_c, self.doff_f,
                             self.doff_c))

    @classmethod
    def tree_unflatten(cls, aux, children):
        obj = cls.__new__(cls)
        (obj.Ps,) = children
        (obj.nf, obj.shapes_f, obj.shapes_c, obj.foff_f, obj.foff_c,
         obj.doff_f, obj.doff_c) = aux
        return obj


jax.tree_util.register_pytree_node(
    MultiPatchProlong,
    lambda p: p.tree_flatten(),
    MultiPatchProlong.tree_unflatten)


def _cast_pytree(obj, dtype):
    """Cast every floating jnp leaf of a registered pytree object."""
    return jax.tree_util.tree_map(
        lambda x: x.astype(dtype)
        if hasattr(x, "dtype") and jnp.issubdtype(x.dtype, jnp.floating)
        else x, obj)


def _as_coupling_list(c):
    """Normalize a single coupling or a sequence of couplings to a list."""
    if c is None:
        return []
    if isinstance(c, (list, tuple)):
        return list(c)
    return [c]


# Safe effective-omega target: omega_eff * lam_max(D^-1 A) = _OMEGA_FAC.
# Weighted Jacobi is stable iff omega*lam_max < 2; the single-patch
# production default omega=0.7 implicitly assumes lam_max <= 2.86, which
# multipatch operators VIOLATE two ways (both measured on the 3-patch
# L-shell, scripts/debug_npatch*.py): penalty-interface rows push
# lam_max(D^-1 A) to ~5.1 (Jacobi sweeps then amplify support error 2.6x
# each, and the trailing Schwarz pass cannot recover the composition --
# two-grid rho 2.67), and even the PURE-STENCIL complement rows reach 3.28
# on anisotropic-element patches.  With omega_eff = 1.8/lam_max the same
# V-cycle contracts at rho ~0.83-0.91 nearly h-independently (nel=2/4/6),
# and the exact-vs-diagonal-approximate Schwarz local matrix makes no
# measurable difference (0.884 vs 0.886) -- the whole fix is the damping.
_OMEGA_FAC = 1.8
_LAM_ITERS = 30


@jax.jit
def _lam_max_jacobi(op, mask, x0):
    """Power-iteration estimate of lam_max(D^-1 A) for the BC'd operator
    (identity on masked rows).  One fused program (static iteration count,
    no data-dependent control flow); one scalar fetch at the caller."""
    d = op.diagonal()
    d = mask * d + (1.0 - mask)
    dinv = 1.0 / d

    def act(x):
        return mask * op(mask * x) + (1.0 - mask) * x

    def body(_, x):
        y = dinv * act(x)
        return y / jnp.linalg.norm(y)

    x = x0 / jnp.linalg.norm(x0)
    x = jax.lax.fori_loop(0, _LAM_ITERS, body, x)
    # generalized Rayleigh quotient (x'Ax)/(x'Dx): exact for the converged
    # eigenvector of the D-symmetrizable pencil, monotone from below
    return jnp.vdot(x, act(x)) / jnp.vdot(x, d * x)


def mp_stencil_to_dense(op: MultiPatchStencilOperator):
    """Densify on the host (numpy index arithmetic only)."""
    n = op.ndof
    S0 = np.asarray(op.sts[0].S)
    A = np.zeros((n, n), dtype=S0.dtype)
    for p, st in enumerate(op.sts):
        Ad = stencil_to_dense(st)
        dp = op.doffsets[p]
        ncp = op.doffsets[p + 1] - dp
        gidx = np.concatenate([of + dp + np.arange(ncp)
                               for of in op.foffsets])
        A[np.ix_(gidx, gidx)] += Ad
    for blk in op.ifaces:
        idx = np.asarray(blk.idx)
        A[np.ix_(idx, idx)] += np.asarray(blk.K)
    return A


class MultiPatchStencilNewton(StencilNewton):
    """StencilNewton over an equal-order multi-patch space with weak
    interface couplings (see module docstring).  Inherits the full
    production/polish driver (step / polish_step / solve, the precision
    model, the evaluation-floor certificates) from StencilNewton;
    everything space-specific is rebuilt here.

    Parameters beyond StencilNewton
    -------------------------------
    coupling     : ONE interface form, or a SEQUENCE of interface forms
                   (one per patch interface) on ``spline``
                   (PenaltyInterfaceCoupling / ShellInterfaceCoupling /
                   EnergyNitscheCoupling / any InterfaceForm) -- folded
                   into residuals, tangents, Jacobi diagonals, the
                   Schwarz smoother, and the coarse dense inverse
    mg_couplings : one entry per entry of ``mg_splines``: the same
                   coupling(s) constructed on each coarser space (a
                   single form or a sequence matching ``coupling``)
    """

    def __init__(self, spline, adjoint_res, coupling, mg_splines=(),
                 mg_couplings=(), cg_iters=15, n_smooth=2, omega=0.7,
                 build_chunk32=None, build_chunk64=1024, setup_log=None,
                 coarse_cache=None, polish_cg_iters=30,
                 polish_tangent="f64", build_quad_degree=None,
                 rebuild_rel=1e-5, hessian=None,
                 polish_residual_device="accel"):
        import os as _os
        import time as _time
        from ..models.multipatch import MultiPatchBSplineBasis

        if len(mg_couplings) != len(mg_splines):
            raise ValueError("need one mg_coupling entry per mg_spline")
        couplings = _as_coupling_list(coupling)
        if not couplings:
            raise ValueError("MultiPatchStencilNewton requires at least "
                             "one interface coupling")
        mg_coupling_lists = [_as_coupling_list(c) for c in mg_couplings]
        for i, cl in enumerate(mg_coupling_lists):
            if len(cl) != len(couplings):
                raise ValueError(
                    f"mg_couplings[{i}] has {len(cl)} forms; the fine "
                    f"level has {len(couplings)}")
        self.spline = spline
        self.adjoint = adjoint_res
        self.couplings = couplings
        self.coupling = couplings[0]        # back-compat alias
        self.cg_iters = int(cg_iters)
        self.asm64 = spline._assembler("dx")
        self.asm32 = self.asm64.astype(jnp.float32)
        self._build_quad_degree = build_quad_degree
        asm64_b = (self.asm64 if build_quad_degree is None
                   else spline._assembler("dx",
                                          quad_degree=build_quad_degree))
        asm32_b = asm64_b.astype(jnp.float32)
        self.asm_b32 = (asm32_b if build_chunk32 is None
                        else asm32_b.with_chunk(build_chunk32))
        self.asm_b64 = (asm64_b if build_chunk64 is None
                        else asm64_b.with_chunk(build_chunk64))
        self.mask64 = spline.mask
        self.mask32 = spline.mask.astype(jnp.float32)
        self.basis = _equal_order_basis(spline)
        if not isinstance(self.basis, MultiPatchBSplineBasis):
            raise ValueError("MultiPatchStencilNewton requires a "
                             "MultiPatchBSplineBasis space; use "
                             "StencilNewton for single patches")
        degs0 = tuple(self.basis.patches[0].degrees)
        for pt in self.basis.patches:
            if tuple(pt.degrees) != degs0:
                # checked input (see module docstring): ragged-degree
                # multipatch tabulations pad to the largest local basis,
                # and padded element-matrix slices do not feed
                # stencil_from_element_matrices -- use SANewton there
                raise NotImplementedError("all patches must share degrees "
                                          "(padded ragged tabulations do "
                                          "not slice into stencils); use "
                                          "solvers.newton_sa.SANewton for "
                                          "ragged-degree spaces")
        self.nf = spline.space.nfields
        self.mg_splines = list(mg_splines)
        self.mg_couplings = mg_coupling_lists
        self._n_smooth = int(n_smooth)
        self._omega = float(omega)
        self._polish_cg_iters = int(polish_cg_iters)
        self.polish_tangent = str(polish_tangent)
        self.rebuild_rel = float(rebuild_rel)
        self.polish_residual_device = str(polish_residual_device)
        self._res_cpu = None
        self.hessian = hessian
        self._st64 = None
        self._P0_f64 = None

        # f32 copies of the couplings (pytree casts; ints/indices survive)
        self._c64 = tuple(couplings)
        self._c32 = tuple(_cast_pytree(c, jnp.float32) for c in couplings)
        adjoint = self.adjoint
        nf = self.nf
        basis = self.basis
        n_iface = len(couplings)

        def _layout(spl):
            b = _equal_order_basis(spl)
            foff = tuple(int(o) for o in spl.space.offsets[:-1])
            doff = tuple(int(o) for o in b.doffsets)
            shapes = [tuple(kv.ncp for kv in reversed(pt.kvs))
                      for pt in b.patches]
            return b, foff, doff, shapes

        _, foff_f, doff_f, shapes_f = _layout(spline)
        self._foff = foff_f
        self._doff = doff_f

        def _elem_mats(asm_, U):
            if hessian is not None:
                return asm_.element_matrices_hessian(hessian, U)
            return asm_.element_matrices_adjoint(adjoint, U)

        def _mp_build(asm_, U, cpls, idxposs, mask, b, foff, doff):
            """Returns (op WITHOUT Sinvs, tuple of per-block S): the dense
            inverses of the BC'd local interface operators S_k are
            computed OUTSIDE the jit on the HOST in f64 (_host_sinv), a
            set-up step: on a penalty-dominated S (kappa >= pd/pr ~ 1e3,
            and much worse against the bending diagonal) a reduced-
            precision inverse error eps*kappa is O(1)+ -- Newton-Schulz
            cannot recover it (it needs |I - S Sinv| < 1) and the
            corrupted Schwarz correction de-SPDs the V-cycle (observed
            with bf16-pass products: the mixed FCG polish step LEAVES a
            40x linear residual against 1.05 in IEEE f32, and Newton
            diverges with NO error).

            Each S_k sums the patch-stencil diagonal at its support, the
            OTHER interface blocks' diagonals there (patches meeting at a
            corner share support DoFs -- their penalty stiffness must be
            visible to this block's local solve), and its own full K_k."""
            E = _elem_mats(asm_, U)
            sts = []
            e0 = 0
            for pt in b.patches:
                sts.append(stencil_from_element_matrices(
                    pt, E[e0:e0 + pt.nel], nf=nf))
                e0 += pt.nel
            blocks = []
            for cpl, (idx, pos_a, pos_b) in zip(cpls, idxposs):
                K = _iform_tangent_block(cpl, U[idx], pos_a, pos_b,
                                         cpl.params)
                blocks.append(IfaceBlock(idx, K, None))
            op = MultiPatchStencilOperator(sts, blocks, foff, doff, nf)
            d_tot = op.diagonal()       # patch + ALL interface diagonals
            Ss = []
            for blk in blocks:
                d_other = d_tot[blk.idx] - jnp.diagonal(blk.K)
                m_idx = mask[blk.idx].astype(blk.K.dtype)
                S = blk.K + jnp.diag(d_other)
                S = (m_idx[:, None] * S * m_idx[None, :]
                     + jnp.diag(1.0 - m_idx))
                Ss.append(S)
            return op, tuple(Ss)

        def _host_sinv(S):
            """Exact f64 host inverse of one local interface operator,
            cast to the f32 the Schwarz preconditioner stores.  One
            [m, m] fetch + host LU per tangent rebuild (m ~ O(1e2-1e3));
            jnp.asarray keeps the result UNCOMMITTED so downstream jits
            still hit the persistent cache (round-3 lesson)."""
            Sh = np.asarray(S, dtype=np.float64)
            return jnp.asarray(np.linalg.inv(Sh).astype(np.float32))

        def _with_sinvs(op, Ss):
            op.ifaces = tuple(
                IfaceBlock(blk.idx, blk.K, _host_sinv(S))
                for blk, S in zip(op.ifaces, Ss))
            return op

        idxpos_f = tuple(c.support_positions() for c in couplings)

        @jax.jit
        def build_fine(asm_, U, cpls, idxposs, mask):
            return _mp_build(asm_, U, cpls, idxposs, mask, basis, foff_f,
                             doff_f)

        self._build_mp = build_fine

        self._fine_omega_scale = 1.0
        self._lam_x0 = jnp.asarray(
            np.random.default_rng(0).normal(size=spline.ndof),
            dtype=jnp.float32)

        def _build(asm_, U):
            f64 = U.dtype == jnp.float64
            op, Ss = build_fine(asm_, U,
                                self._c64 if f64 else self._c32,
                                idxpos_f,
                                self.mask64 if f64 else self.mask32)
            # the Schwarz inverses are preconditioner-only (always f32 and
            # only ever applied through the f32 V-cycle): f64 operator
            # builds never smooth, so skip the host round trips for them
            if not f64:
                op = _with_sinvs(op, Ss)
                # spectrum-safe smoother damping (see _OMEGA_FAC): one
                # fused power-iteration program + one scalar fetch per
                # f32 tangent rebuild
                lam = float(_lam_max_jacobi(op, self.mask32, self._lam_x0))
                self._fine_omega_scale = min(
                    1.0, _OMEGA_FAC / (self._omega * lam))
            return op

        self._build = _build

        @jax.jit
        def res(asm_, mask, U, cpls):
            r = asm_.residual_vector_adjoint(adjoint, U)
            for c in cpls:
                r = r + jax.grad(c.energy)(U)
            return mask * r

        self._res = lambda asm_, mask, U: res(
            asm_, mask, U,
            self._c64 if U.dtype == jnp.float64 else self._c32)

        if self.polish_residual_device == "cpu":
            _t0 = _time.time()
            self._cpu_res()
            if setup_log:
                setup_log(f"  host-CPU f64 residual assembler built "
                          f"({_time.time() - _t0:.1f}s)")

        # -- multigrid ladder --------------------------------------------------
        all_splines = [spline] + self.mg_splines
        layouts = [_layout(s) for s in all_splines]
        nlev = len(all_splines)
        self._mgcg = make_stencil_mgcg(nlev, n_smooth=n_smooth,
                                       omega=omega, n_iters=self.cg_iters)
        self._mgcg_mixed = make_stencil_mgcg_mixed(
            nlev, n_smooth=n_smooth, omega=omega,
            n_iters=int(polish_cg_iters))
        prolongs = []
        for i in range(nlev - 1):
            bf, foff_fi, doff_fi, shapes_fi = layouts[i]
            bc, foff_ci, doff_ci, shapes_ci = layouts[i + 1]
            Ps = []
            for pf, pc in zip(bf.patches, bc.patches):
                Ps.append(tuple(jnp.asarray(insertion_matrix_1d(kc, kf),
                                            dtype=jnp.float32)
                                for kc, kf in zip(reversed(pc.kvs),
                                                  reversed(pf.kvs))))
            prolongs.append(MultiPatchProlong(
                Ps, nf, shapes_fi, shapes_ci, foff_fi, foff_ci,
                doff_fi, doff_ci))
        self._Ps = tuple(prolongs)

        # -- coarse operators (zero state; optional disk cache) ---------------
        cached = None
        if coarse_cache and _os.path.exists(coarse_cache):
            try:
                with np.load(coarse_cache) as z:
                    cached = {k: z[k] for k in z.files}
            except Exception:
                cached = None
        # v4: caches written before the precision fix carry a corrupted
        # Sinv (built by an f32 LU whose internal matmuls ran as bf16
        # passes; see _mp_build docstring).
        # v5: multi-interface format (per-block K{i}_{k} / Sinv{i}_{k});
        # absent/older version keys force a rebuild.
        loaded = (cached is not None
                  and int(cached.get("n", -1)) == len(self.mg_splines)
                  and int(cached.get("n_iface", -1)) == n_iface
                  and int(cached.get("v", 1)) >= 5)
        coarse_sts, diags, masks = [], [], []
        dense_inv = None
        for i, (spl, cpls) in enumerate(zip(self.mg_splines,
                                            self.mg_couplings)):
            _t0 = _time.time()
            b_c, foff_c, doff_c, _ = _layout(spl)
            cpls32 = tuple(_cast_pytree(c, jnp.float32) for c in cpls)
            idxpos_c = tuple(c.support_positions() for c in cpls32)
            if loaded:
                sts = [StencilOperator(
                    jnp.asarray(cached[f"S{i}_{p}"]),
                    tuple(kv.ncp for kv in reversed(pt.kvs)),
                    tuple(kv.p for kv in reversed(pt.kvs)), nf)
                    for p, pt in enumerate(b_c.patches)]
                blocks = tuple(
                    IfaceBlock(idxpos_c[k][0],
                               jnp.asarray(cached[f"K{i}_{k}"]),
                               jnp.asarray(cached[f"Sinv{i}_{k}"]))
                    for k in range(n_iface))
                op = MultiPatchStencilOperator(sts, blocks, foff_c,
                                               doff_c, nf)
            else:
                asm_c = spl._assembler("dx").astype(jnp.float32)
                asm_c = asm_c.with_chunk(1024)
                build_c = jax.jit(
                    lambda a, U, c, ip, mk, b=b_c, fo=foff_c, do=doff_c:
                    _mp_build(a, U, c, ip, mk, b, fo, do))
                op, Ss_c = build_c(asm_c,
                                   jnp.zeros(spl.ndof, dtype=jnp.float32),
                                   cpls32, idxpos_c,
                                   spl.mask.astype(jnp.float32))
                op = _with_sinvs(op, Ss_c)
            m_h = np.asarray(spl.mask, dtype=np.float64)
            d = np.asarray(op.diagonal())
            d = m_h * d + (1.0 - m_h)
            coarse_sts.append(op)
            m32 = jnp.asarray(m_h, dtype=jnp.float32)
            # spectrum-safe per-level damping (see _OMEGA_FAC): the level's
            # effective omega is folded into its stored Jacobi dinv (the
            # fused smoothers only ever use omega*dinv); coarse operators
            # are frozen at the zero state, so once per setup suffices
            lam_c = float(_lam_max_jacobi(op, m32, jnp.asarray(
                np.random.default_rng(1 + i).normal(size=spl.ndof),
                dtype=jnp.float32)))
            sc = min(1.0, _OMEGA_FAC / (self._omega * lam_c))
            diags.append(jnp.asarray(sc / d, dtype=jnp.float32))
            masks.append(m32)
            if i == len(self.mg_splines) - 1:
                if loaded:
                    dense_inv = jnp.asarray(cached["inv"],
                                            dtype=jnp.float32)
                else:
                    A = mp_stencil_to_dense(op)
                    cpu = jax.devices("cpu")[0]
                    A = np.asarray(apply_bc_matrix(
                        jax.device_put(jnp.asarray(A), cpu),
                        jax.device_put(jnp.asarray(m_h), cpu)))
                    dense_inv = jnp.asarray(np.linalg.inv(A),
                                            dtype=jnp.float32)
            if setup_log:
                setup_log(f"    coarse level {i} ({spl.ndof} dofs"
                          f"{', cached' if loaded else ''}): "
                          f"{_time.time() - _t0:.1f}s, "
                          f"lam_max(D^-1A)={lam_c:.2f}, "
                          f"omega_eff={sc * self._omega:.3f}")
        if coarse_cache and not loaded and self.mg_splines:
            payload = {"n": np.asarray(len(self.mg_splines)),
                       "n_iface": np.asarray(n_iface),
                       "v": np.asarray(5),
                       "inv": np.asarray(dense_inv)}
            for i, op in enumerate(coarse_sts):
                for p, st in enumerate(op.sts):
                    payload[f"S{i}_{p}"] = np.asarray(st.S)
                for k, blk in enumerate(op.ifaces):
                    payload[f"K{i}_{k}"] = np.asarray(blk.K)
                    payload[f"Sinv{i}_{k}"] = np.asarray(blk.Sinv)
            _os.makedirs(_os.path.dirname(coarse_cache) or ".",
                         exist_ok=True)
            np.savez(coarse_cache, **payload)
            if setup_log:
                setup_log(f"    coarse operators saved to {coarse_cache}")
        if not self.mg_splines:
            raise ValueError("MultiPatchStencilNewton requires at least "
                             "one coarser spline in mg_splines")
        self._coarse_sts = tuple(coarse_sts)
        self._coarse_dinvs = tuple(diags)
        self._coarse_masks = tuple(masks)
        self._coarse_inv = dense_inv

    # -- space-specific overrides -------------------------------------------------

    def _cpu_res_build(self):
        cpu = jax.devices("cpu")[0]
        asm_cpu = jax.tree_util.tree_map(
            lambda x: jax.device_put(x, cpu),
            self.spline._assembler("dx", device=cpu))
        mask_cpu = jax.device_put(self.mask64, cpu)
        c_cpu = tuple(jax.tree_util.tree_map(
            lambda x: jax.device_put(x, cpu), c) for c in self._c64)
        adjoint = self.adjoint

        @jax.jit
        def rc_full(a, m, u, cs):
            r = a.residual_vector_adjoint(adjoint, u)
            for c in cs:
                r = r + jax.grad(c.energy)(u)
            return m * r

        self._res_cpu = (lambda a, m, u: rc_full(a, m, u, c_cpu),
                         asm_cpu, mask_cpu)

    def coarse_solver(self, **kwargs):
        raise NotImplementedError("nested iteration is not wired for the "
                                  "multipatch solver (the flat solve is "
                                  "the production path)")

    def solve_nested(self, *a, **k):
        raise NotImplementedError("nested iteration is not wired for the "
                                  "multipatch solver")

    def prolong_solution(self, Uc):
        return self.mask64 * self._Ps[0].up(
            Uc.astype(self.spline.dtype)).astype(self.spline.dtype)
