"""Kirchhoff-Love shell kinematics and material utilities.

The reference implements these as demo-level UFL code
(demos/kl-shell-hyper/kl-hyper.py:94-212, demos/kl-shell-svk/
dynamic-tspline.py:135-212); here they are a library module operating on
quadrature-point jets.  All parametric differentiation of derived quantities
(covariant bases, unit normal and its derivatives, curvature) is done with
forward-mode AD through the configuration's Taylor polynomial, which is
exact for the tabulated jet orders.

Requires a spline built with nders=2 (displacement Hessians) on a
2-parametric-dimension control mesh embedded in 3D (extra_dim=1 explicit
B-splines, NURBS surfaces, or T-splines).
"""

from __future__ import annotations

from typing import NamedTuple, Any

import jax
import jax.numpy as jnp

from ..forms import Jet, taylor_eval
from ..ops.smallmat import det_small, inv_small


class MidsurfaceGeometry(NamedTuple):
    """Covariant midsurface data in one configuration
    (kl-hyper.py:99-115)."""
    a0: Any        # [3] covariant basis vector (xi_0 direction)
    a1: Any        # [3]
    a2: Any        # [3] unit normal
    deriv_a2: Any  # [3,2] parametric derivatives of the unit normal
    a: Any         # [2,2] midsurface metric
    b: Any         # [2,2] curvature tensor


def _unit(v):
    return v / jnp.sqrt(jnp.dot(v, v))


def configuration_fn(ctx, y=None):
    """Taylor-polynomial (in parametric offset) of the shell configuration:
    reference midsurface X = F, optionally deformed by a displacement jet
    ``y`` (already rationalized): x = X + y (kl-hyper.py:89-92)."""
    def xfun(delta):
        X = taylor_eval(ctx.x, ctx.DF, ctx.d2F, delta)
        if y is None:
            return X
        return X + taylor_eval(y.val, y.g, y.h, delta)
    return xfun


def midsurface_geometry(ctx, y=None):
    """Covariant basis, unit normal (+ parametric derivatives), metric, and
    curvature of the (possibly deformed) midsurface.

    Closed-form: the configuration's parametric Jacobian and Hessian are
    exactly (DF + y.g) and (d2F + y.h), so the unit normal's parametric
    derivative is d(unit(n))_c = (I - a2 a2^T) dn_c / |n| with
    dn_c = cross(H[:,0,c], a1) + cross(a0, H[:,1,c]) -- no nested AD, which
    keeps the XLA graphs of shell residual/tangent assembly compact."""
    G = ctx.DF if y is None else ctx.DF + y.g            # [3, 2]
    H = ctx.d2F if y is None else ctx.d2F + y.h          # [3, 2, 2]
    a0 = G[:, 0]
    a1 = G[:, 1]
    n = jnp.cross(a0, a1)
    nn = jnp.sqrt(jnp.dot(n, n))
    a2 = n / nn

    # dn[:, c] = cross(dx0/dxi_c, a1) + cross(a0, dx1/dxi_c)
    dn = (jnp.cross(H[:, 0, :], a1[:, None], axisa=0, axisb=0, axisc=0)
          + jnp.cross(a0[:, None], H[:, 1, :], axisa=0, axisb=0, axisc=0))
    deriv_a2 = (dn - a2[:, None] * (a2 @ dn)[None, :]) / nn

    a = G.T @ G
    b = -G.T @ deriv_a2
    b = 0.5 * (b + b.T)
    return MidsurfaceGeometry(a0, a1, a2, deriv_a2, a, b)


def curvilinear_basis(geom: MidsurfaceGeometry, xi2):
    """In-plane curvilinear basis at through-thickness coordinate xi2
    (kl-hyper.py:123-126)."""
    g0 = geom.a0 + xi2 * geom.deriv_a2[:, 0]
    g1 = geom.a1 + xi2 * geom.deriv_a2[:, 1]
    return g0, g1


def metric_at(geom: MidsurfaceGeometry, xi2):
    """Shell metric at xi2, dropping terms quadratic in xi2
    (kl-hyper.py:128-131)."""
    return geom.a - 2.0 * xi2 * geom.b


def local_cartesian_basis(a0, a1):
    """Gram-Schmidt local Cartesian frame (kl-hyper.py:133-140)."""
    e0 = _unit(a0)
    e1 = _unit(a1 - e0 * jnp.dot(a1, e0))
    return e0, e1


def tensor_to_cartesian(T, a, a0, a1):
    """Transform a covariant 2-tensor from the (a0, a1) curvilinear basis
    with metric ``a`` to the local Cartesian frame (kl-hyper.py:142-165)."""
    ac = inv_small(a)
    a0c = ac[0, 0] * a0 + ac[0, 1] * a1
    a1c = ac[1, 0] * a0 + ac[1, 1] * a1
    e0, e1 = local_cartesian_basis(a0, a1)
    ea = jnp.asarray([[jnp.dot(e0, a0c), jnp.dot(e0, a1c)],
                      [jnp.dot(e1, a0c), jnp.dot(e1, a1c)]])
    return ea @ T @ ea.T


def incompressible_strain(E_2D):
    """Build the full 3D Green-Lagrange strain in the local Cartesian frame
    from the in-plane strain, with E22 determined by exact plane-stress
    incompressibility (kl-hyper.py:185-197)."""
    C_2D = 2.0 * E_2D + jnp.eye(2, dtype=E_2D.dtype)
    C22 = 1.0 / det_small(C_2D)
    E22 = 0.5 * (C22 - 1.0)
    E = jnp.zeros((3, 3), dtype=E_2D.dtype)
    E = E.at[:2, :2].set(E_2D)
    E = E.at[2, 2].set(E22)
    return E


def incompressible_psi(E_2D, psi_el):
    """Total strain-energy density for an incompressible material with the
    exact plane-stress pressure Lagrange multiplier
    (kl-hyper.py:167-200): psi = psi_el(E) - p(E) (J - 1), with
    p = 2 d(psi_el)/dC_22 * C22."""
    E = incompressible_strain(E_2D)
    C = 2.0 * E + jnp.eye(3, dtype=E.dtype)
    J = jnp.sqrt(det_small(C))

    def psi_of_E(Evar):
        return psi_el(Evar)

    dpsi_dE = jax.grad(psi_of_E)(E)
    dpsi_dC22 = 0.5 * dpsi_dE[2, 2]
    C22 = 2.0 * E[2, 2] + 1.0
    p = 2.0 * dpsi_dC22 * C22
    return psi_of_E(E) - p * (J - 1.0)


def kl_strain_at(ctx, y, xi2):
    """Local-Cartesian in-plane Green-Lagrange strain at through-thickness
    coordinate xi2, for displacement jet ``y`` (kl-hyper.py:185-190)."""
    ref = midsurface_geometry(ctx)
    cur = midsurface_geometry(ctx, y)
    G = metric_at(ref, xi2)
    g = metric_at(cur, xi2)
    E_flat = 0.5 * (g - G)
    G0, G1 = curvilinear_basis(ref, xi2)
    return tensor_to_cartesian(E_flat, G, G0, G1)


class ShellReference(NamedTuple):
    """Geometry-only Kirchhoff-Love reference data at one quadrature point,
    precomputable once per spline (see precompute_shell_reference): the
    reference metric/curvature and the curvilinear-to-local-Cartesian
    transformation matrix.  Hoisting this out of the density removes the
    reference-side cross products, normalizations (sqrt/div), and the 2x2
    frame inverse from EVERY assembly/AD evaluation."""
    a: Any    # [2,2] reference midsurface metric
    b: Any    # [2,2] reference curvature
    ea: Any   # [2,2] covariant -> local-Cartesian transformation


def cartesian_frame_matrix(a, a0, a1):
    """The (e_i . a^j) matrix of tensor_to_cartesian as a reusable value."""
    ac = inv_small(a)
    a0c = ac[0, 0] * a0 + ac[0, 1] * a1
    a1c = ac[1, 0] * a0 + ac[1, 1] * a1
    e0, e1 = local_cartesian_basis(a0, a1)
    return jnp.asarray([[jnp.dot(e0, a0c), jnp.dot(e0, a1c)],
                        [jnp.dot(e1, a0c), jnp.dot(e1, a1c)]])


def shell_reference(ctx):
    """ShellReference of the reference configuration at one point."""
    ref = midsurface_geometry(ctx)
    return ShellReference(a=ref.a, b=ref.b,
                          ea=cartesian_frame_matrix(ref.a, ref.a0, ref.a1))


def precompute_shell_reference(spline, domain="dx"):
    """Attach precomputed ShellReference data to the spline's assembler
    ctx (under ``ctx.aux['shell_ref']``); subsequent svk_psi_surface
    evaluations skip all reference-side geometry work.  Call once after
    constructing the ExtractedSpline (nders=2).  Registered as a ctx
    hook, so assemblers created LATER (e.g. the reduced-quadrature
    tangent-build assembler of StencilNewton(build_quad_degree=...))
    get their own shell_ref automatically."""
    def attach(dom, asm):
        if dom != domain:
            return
        fn = jax.vmap(shell_reference)
        if asm.ctx.x.ndim == 3:   # [nel, nq, ...] generic layout
            fn = jax.vmap(fn)
        ref = jax.jit(fn)(asm.ctx)
        aux = dict(asm.ctx.aux or {})
        aux["shell_ref"] = ref
        asm.ctx = asm.ctx._replace(aux=aux)

    for quad_key in list(spline._assemblers.keys()):
        attach(quad_key[0], spline._assemblers[quad_key])
    spline._ctx_hooks.append(attach)
    spline._jit_cache.clear()
    return spline


def svk_shell_residual(ctx, y, v, E_mod, nu, h_th):
    """Hand-derived first variation dW(y; v) of ``svk_psi_surface``:
    mathematically identical to ``deriv(lambda y: svk_psi_surface(...),
    y, v)`` (tested to f64 roundoff) but structurally cheaper to assemble:
    the expression separates the v-independent primal (geometry, strains,
    stress resultants) from the terms LINEAR in the test jet ``v``, so the
    reverse-mode transpose that assembly performs over ``v`` only
    traverses the linear tail instead of the whole energy/JVP graph.

    Requires ctx.aux['shell_ref'] (precompute_shell_reference).  All
    symbols follow midsurface_geometry; the variation formulas are the
    exact differentials of that closed-form chain.
    """
    sref = ctx.aux["shell_ref"]
    ref_a, ref_b, ea = sref.a, sref.b, sref.ea

    # primal (v-independent) ---------------------------------------------------
    G = ctx.DF + y.g                                  # [3, 2]
    H = ctx.d2F + y.h                                 # [3, 2, 2]
    a0, a1 = G[:, 0], G[:, 1]
    n = jnp.cross(a0, a1)
    nn = jnp.sqrt(jnp.dot(n, n))
    a2 = n / nn
    dn = (jnp.cross(H[:, 0, :], a1[:, None], axisa=0, axisb=0, axisc=0)
          + jnp.cross(a0[:, None], H[:, 1, :], axisa=0, axisb=0, axisc=0))
    a2dn = a2 @ dn                                    # [2]
    deriv_a2 = (dn - a2[:, None] * a2dn[None, :]) / nn
    cur_a = G.T @ G
    b_uns = -(G.T @ deriv_a2)
    cur_b = 0.5 * (b_uns + b_uns.T)
    eps = ea @ (0.5 * (cur_a - ref_a)) @ ea.T
    kap = ea @ (cur_b - ref_b) @ ea.T

    lam_ps = E_mod * nu / (1.0 - nu ** 2)
    mu = E_mod / (2.0 * (1.0 + nu))
    I2 = jnp.eye(2, dtype=eps.dtype)
    Nm = h_th * (lam_ps * jnp.trace(eps) * I2 + 2.0 * mu * eps)
    Mm = h_th ** 3 / 12.0 * (lam_ps * jnp.trace(kap) * I2 + 2.0 * mu * kap)
    # pull the stress resultants back to the covariant frame:
    # Nm : (ea X ea^T) == (ea^T Nm ea) : X
    Nb = ea.T @ Nm @ ea
    Mb = ea.T @ Mm @ ea

    # linear in the test jet v ---------------------------------------------------
    dG = v.g
    dH = v.h
    da0, da1 = dG[:, 0], dG[:, 1]
    dnt = jnp.cross(da0, a1) + jnp.cross(a0, da1)
    dnn = jnp.dot(n, dnt) / nn
    da2 = (dnt - a2 * dnn) / nn
    ddn = (jnp.cross(dH[:, 0, :], a1[:, None], axisa=0, axisb=0, axisc=0)
           + jnp.cross(H[:, 0, :], da1[:, None], axisa=0, axisb=0, axisc=0)
           + jnp.cross(da0[:, None], H[:, 1, :], axisa=0, axisb=0, axisc=0)
           + jnp.cross(a0[:, None], dH[:, 1, :], axisa=0, axisb=0, axisc=0))
    dderiv_a2 = ((ddn - da2[:, None] * a2dn[None, :]
                  - a2[:, None] * (da2 @ dn)[None, :]
                  - a2[:, None] * (a2 @ ddn)[None, :]) / nn
                 - deriv_a2 * (dnn / nn))
    d_cur_a = dG.T @ G + G.T @ dG
    db_uns = -(dG.T @ deriv_a2 + G.T @ dderiv_a2)
    d_cur_b = 0.5 * (db_uns + db_uns.T)
    return (jnp.sum(Nb * (0.5 * d_cur_a)) + jnp.sum(Mb * d_cur_b))


def svk_shell_adjoint(ctx, y, E_mod, nu, h_th):
    """ADJOINT JET of the SVK shell residual: the Jet F = (Fval, Fg, Fh)
    with  svk_shell_residual(ctx, y, v, ...) == sum(F.g * v.g)
    + sum(F.h * v.h)  for every test jet v (Fval = 0; add external loads
    on top).  Assembling with ops/assembly.residual_vector_adjoint then
    involves NO reverse-mode AD at all -- the v-contraction becomes an
    explicit einsum with the tabulations: the reverse sweep through the
    residual density generates far more code than these closed forms.

    Derivation (transpose of the linear tail of svk_shell_residual, all
    cross-product transposes via the triple-product identity
    t.(a x b) = a.(b x t) = b.(t x a)):

      dW = Nb : (0.5 d_cur_a) + Mb : d_cur_b
         = dG : (G Nb - deriv_a2 Mb) + S : dderiv_a2,     S := -G Mb
      S : dderiv_a2 = sum_c R_c . ddn_c + t . dnt
      with   R_c = (S_c - (S_c.a2) a2)/nn
             Q   = -(S @ a2dn + dn @ (a2 @ S))/nn
             rho = -(S : deriv_a2)/nn
             t   = (Q - (Q.a2) a2)/nn + rho a2
      and the cross-transposes
             t . dnt      -> Fg[:,0] += a1 x t,   Fg[:,1] += t x a0
             R_c . ddn_c  -> Fh[:,0,c] = a1 x R_c, Fh[:,1,c] = R_c x a0,
                             Fg[:,0] += sum_c H[:,1,c] x R_c,
                             Fg[:,1] += sum_c R_c x H[:,0,c].

    Identity with AD pinned in
    tests/test_kl_shell.py::test_adjoint_matches_ad.
    """
    sref = ctx.aux["shell_ref"]
    ref_a, ref_b, ea = sref.a, sref.b, sref.ea

    # primal (identical to svk_shell_residual) -------------------------------
    G = ctx.DF + y.g                                  # [3, 2]
    H = ctx.d2F + y.h                                 # [3, 2, 2]
    a0, a1 = G[:, 0], G[:, 1]
    n = jnp.cross(a0, a1)
    nn = jnp.sqrt(jnp.dot(n, n))
    a2 = n / nn
    dn = (jnp.cross(H[:, 0, :], a1[:, None], axisa=0, axisb=0, axisc=0)
          + jnp.cross(a0[:, None], H[:, 1, :], axisa=0, axisb=0, axisc=0))
    a2dn = a2 @ dn                                    # [2]
    deriv_a2 = (dn - a2[:, None] * a2dn[None, :]) / nn
    cur_a = G.T @ G
    b_uns = -(G.T @ deriv_a2)
    cur_b = 0.5 * (b_uns + b_uns.T)
    eps = ea @ (0.5 * (cur_a - ref_a)) @ ea.T
    kap = ea @ (cur_b - ref_b) @ ea.T
    lam_ps = E_mod * nu / (1.0 - nu ** 2)
    mu = E_mod / (2.0 * (1.0 + nu))
    I2 = jnp.eye(2, dtype=eps.dtype)
    Nm = h_th * (lam_ps * jnp.trace(eps) * I2 + 2.0 * mu * eps)
    Mm = h_th ** 3 / 12.0 * (lam_ps * jnp.trace(kap) * I2 + 2.0 * mu * kap)
    Nb = ea.T @ Nm @ ea
    Mb = ea.T @ Mm @ ea

    # adjoint ----------------------------------------------------------------
    S = -(G @ Mb)                                     # [3, 2]
    Sa2 = a2 @ S                                      # [2]  (S_c . a2)
    R = (S - a2[:, None] * Sa2[None, :]) / nn         # [3, 2]
    Q = -(S @ a2dn + dn @ Sa2) / nn                   # [3]
    rho = -jnp.sum(S * deriv_a2) / nn
    t = (Q - a2 * jnp.dot(a2, Q)) / nn + rho * a2     # [3]

    Fg = G @ Nb - deriv_a2 @ Mb                       # [3, 2]
    cross_c = lambda A, B: jnp.cross(A, B, axisa=0, axisb=0, axisc=0)
    Fg = Fg.at[:, 0].add(jnp.cross(a1, t)
                         + jnp.sum(cross_c(H[:, 1, :], R), axis=1))
    Fg = Fg.at[:, 1].add(jnp.cross(t, a0)
                         + jnp.sum(cross_c(R, H[:, 0, :]), axis=1))
    Fh = jnp.stack([cross_c(jnp.broadcast_to(a1[:, None], R.shape), R),
                    cross_c(R, jnp.broadcast_to(a0[:, None], R.shape))],
                   axis=1)                            # [3, 2(row i), 2(c)]
    return Jet(jnp.zeros(3, dtype=Fg.dtype), Fg, Fh)


def svk_shell_tangent_adjoint(ctx, y, w, E_mod, nu, h_th):
    """Directional derivative of the adjoint jet: the Jet dF with
    d/de svk_shell_residual(ctx, y + e*w, v, ...) == sum(dF.g * v.g)
    + sum(dF.h * v.h).  Assembling dF over the test space gives the exact
    tangent ACTION K(y) @ W with forward-mode AD only (JVP through the
    closed-form adjoint) -- no reverse sweep anywhere."""
    import jax as _jax
    return _jax.jvp(lambda yy: svk_shell_adjoint(ctx, yy, E_mod, nu, h_th),
                    (y,), (w,))[1]


def _eps3(dtype):
    """Levi-Civita tensor (cached per call site by XLA constant folding)."""
    import numpy as _np
    e = _np.zeros((3, 3, 3))
    e[0, 1, 2] = e[1, 2, 0] = e[2, 0, 1] = 1.0
    e[0, 2, 1] = e[2, 1, 0] = e[1, 0, 2] = -1.0
    return jnp.asarray(e, dtype=dtype)


def svk_shell_hessian(ctx, y, E_mod, nu, h_th):
    """HAND-DERIVED pointwise jet-Hessian K [21, 21] of the SVK shell
    energy: for any two displacement jets v, w (flattened in Jet ravel
    order val[3], g[3,2], h[3,2,2]),

        v_flat @ K @ w_flat == d^2/(de df) svk_psi_surface(ctx,
                                   y + e*v + f*w, ...) |_{e=f=0}

    on the symmetric-Hessian subspace (jets with h[:,c,d] == h[:,d,c] --
    the only jets tabulation ever produces).  Replaces the 21-direction
    ``jacfwd`` sweep of ``svk_shell_adjoint`` inside
    ``ops/assembly.element_matrices_adjoint`` with a FIXED set of small
    coefficient-tensor contractions, which is the cheap structure for the
    tangent-stencil build (the dominant term of the production Newton
    step at 128^2 on the earlier target).

    Derivation: with z = (g, h) the 18 non-val jet slots, materialize the
    LINEAR maps of the first-variation chain of ``midsurface_geometry``
    as coefficient matrices over z (Dn, Dnn, Da2, Ddn_c, Ds_c,
    Dderiv_c), then write the second variation as

      d2W = h  [lam (C1:Ev)(C1:Ew) + 2 mu Ev:(C1 Ew C1)]     (membrane)
          + Nb : (dGv^T dGw)                                  (geo memb.)
          + h^3/12 [lam (C1:Bv)(C1:Bw) + 2 mu Bv:(C1 Bw C1)] (bending)
          + Mb : d2(cur_b)(v, w)                              (geo bend.)

    with Ev = 0.5 d(cur_a)(v), Bv = d(cur_b)(v), C1 = ea^T ea, and the
    geometric bending term expanded through the exact second variation of
    the normalized-normal chain (atoms A-F in the code below; every
    bilinear cross-product atom x.(p x q) becomes the matrix -C(x) via
    the triple-product identity, C(x) the cross-product matrix).
    Identity with the AD build pinned to f64 roundoff in
    tests/test_kl_shell.py::test_hessian_matches_jacfwd.
    """
    sref = ctx.aux["shell_ref"]
    ref_a, ref_b, ea = sref.a, sref.b, sref.ea

    # primal chain (identical to svk_shell_adjoint) --------------------------
    G = ctx.DF + y.g                                  # [3, 2]
    H = ctx.d2F + y.h                                 # [3, 2, 2]
    dt = G.dtype
    a0, a1 = G[:, 0], G[:, 1]
    n = jnp.cross(a0, a1)
    nn = jnp.sqrt(jnp.dot(n, n))
    a2 = n / nn
    dn = (jnp.cross(H[:, 0, :], a1[:, None], axisa=0, axisb=0, axisc=0)
          + jnp.cross(a0[:, None], H[:, 1, :], axisa=0, axisb=0, axisc=0))
    s = a2 @ dn                                       # [2]
    deriv_a2 = (dn - a2[:, None] * s[None, :]) / nn
    cur_a = G.T @ G
    b_uns = -(G.T @ deriv_a2)
    cur_b = 0.5 * (b_uns + b_uns.T)
    eps = ea @ (0.5 * (cur_a - ref_a)) @ ea.T
    kap = ea @ (cur_b - ref_b) @ ea.T
    lam_ps = E_mod * nu / (1.0 - nu ** 2)
    mu = E_mod / (2.0 * (1.0 + nu))
    I2 = jnp.eye(2, dtype=dt)
    I3 = jnp.eye(3, dtype=dt)
    Nm = h_th * (lam_ps * jnp.trace(eps) * I2 + 2.0 * mu * eps)
    Mm = h_th ** 3 / 12.0 * (lam_ps * jnp.trace(kap) * I2 + 2.0 * mu * kap)
    Nb = ea.T @ Nm @ ea
    Mb = ea.T @ Mm @ ea
    C1 = ea.T @ ea

    E3 = _eps3(dt)
    cxm = lambda x: jnp.einsum("ijk,j->ik", E3, x)    # C(x) q = x cross q
    Ca0, Ca1 = cxm(a0), cxm(a1)

    def flat18(Ag, Ah):
        """[3, 3, 2] g-coefficients + [3, 3, 2, 2] h-coefficients -> the
        [3, 18] coefficient matrix over the flattened non-val slots."""
        return jnp.concatenate([Ag.reshape(3, 6), Ah.reshape(3, 12)], -1)

    zero_h = jnp.zeros((3, 3, 2, 2), dtype=dt)
    # first-variation coefficient matrices over z -----------------------------
    # delta n = -C(a1) v_g[:,0] + C(a0) v_g[:,1]
    Dn = flat18(jnp.stack([-Ca1, Ca0], axis=2), zero_h)          # [3, 18]
    Dnn = a2 @ Dn                                                # [18]
    Da2 = (Dn - a2[:, None] * Dnn[None, :]) / nn                 # [3, 18]
    # delta dn_c = -C(a1) v_h[:,0,c] + C(H[:,0,c]) v_g[:,1]
    #              - C(H[:,1,c]) v_g[:,0] + C(a0) v_h[:,1,c]
    Ddn = []
    for c in range(2):
        Ag = jnp.stack([-cxm(H[:, 1, c]), cxm(H[:, 0, c])], axis=2)
        Ah = zero_h.at[:, :, 0, c].set(-Ca1).at[:, :, 1, c].set(Ca0)
        Ddn.append(flat18(Ag, Ah))
    Ddn = jnp.stack(Ddn)                                         # [2, 3, 18]
    Ds = (jnp.einsum("ic,iX->cX", dn, Da2)
          + jnp.einsum("i,ciX->cX", a2, Ddn))                    # [2, 18]
    Dderiv = ((Ddn - jnp.einsum("iX,c->ciX", Da2, s)
               - jnp.einsum("i,cX->ciX", a2, Ds)) / nn
              - jnp.einsum("ic,X->ciX", deriv_a2, Dnn) / nn)     # [2, 3, 18]

    # strain-variation coefficient matrices ----------------------------------
    pad22 = jnp.zeros((2, 2, 12), dtype=dt)
    # Ev = 0.5 (Vg^T G + G^T Vg)
    Pm_g = 0.5 * (jnp.einsum("ce,id->cdie", I2, G)
                  + jnp.einsum("de,ic->cdie", I2, G))
    P_m = jnp.concatenate([Pm_g.reshape(2, 2, 6), pad22], -1)    # [2, 2, 18]
    # Bv = d(cur_b)(v) = -sym(Vg^T deriv_a2 + G^T delta(deriv_a2))
    T1 = jnp.concatenate(
        [jnp.einsum("ce,id->cdie", I2, deriv_a2).reshape(2, 2, 6), pad22],
        -1)
    T2 = jnp.einsum("ic,diX->cdX", G, Dderiv)
    P_b = -0.5 * (T1 + T1.transpose(1, 0, 2)
                  + T2 + T2.transpose(1, 0, 2))                  # [2, 2, 18]

    # ---- rank-1 row stack: K_dense = L^T R --------------------------------
    # Every full-[18,18] term is a sum of outer products l (x) r of
    # [18]-row pairs; stacking ALL of them into two [m, 18] factors turns
    # the whole accumulation into ONE batched matmul instead of a
    # dozen device-memory round trips over [npts, 18, 18] (the first implementation
    # did the latter and measured 2.3x SLOWER than the jacfwd build).
    S = -(G @ Mb)                                     # u_c = S[:, c]
    mu_c = a2 @ S                                     # [2]
    wt = (S - a2[:, None] * mu_c[None, :]) / nn       # [3, 2] w-tilde
    yv = (S @ s + dn @ mu_c) / nn                     # [3]
    ya2 = jnp.dot(yv, a2)
    yDa2 = (yv @ Da2) / nn                            # [18]
    rho_b = jnp.sum(S * deriv_a2) / nn
    ru = jnp.einsum("ic,iX->cX", S, Da2) / nn         # [2, 18]
    uDd = jnp.einsum("ic,ciX->X", S, Dderiv) / nn     # [18]
    # geometric bending part 1: -Mb:(Vg^T dderiv(w)) + transpose, as rows
    # over the 6 constant g-slot selectors
    Tg = -jnp.einsum("cd,diX->icX", Mb, Dderiv).reshape(6, 18)
    E6 = jnp.concatenate([jnp.eye(6, dtype=dt),
                          jnp.zeros((6, 12), dtype=dt)], -1)

    def material_rows(P, coef):
        P4 = P.reshape(4, 18)
        tm = jnp.einsum("cd,cdX->X", C1, P)
        PC = jnp.einsum("ca,abX,bd->cdX", C1, P, C1).reshape(4, 18)
        return ([coef * lam_ps * tm[None, :], 2.0 * coef * mu * PC],
                [tm[None, :], P4])

    Lm, Rm = material_rows(P_m, h_th)
    Lb, Rb = material_rows(P_b, h_th ** 3 / 12.0)
    DaS = Da2 * (ya2 / nn - rho_b)                    # atom B+F: Dn^T Da2
    muDdn = jnp.einsum("c,ciX->ciX", mu_c / nn, Ddn).reshape(6, 18)
    L = jnp.concatenate(
        Lm + Lb + [Dn, Dnn[None, :], yDa2[None, :],
                   -ru, -Ds, -Da2,
                   -uDd[None, :], -Dnn[None, :], E6, Tg])
    R = jnp.concatenate(
        Rm + Rb + [DaS, yDa2[None, :], Dnn[None, :],
                   Ds, ru, muDdn[:3],
                   Dnn[None, :], uDd[None, :], Tg, E6])
    K = L.T @ R

    # atom D needs Da2(v).Ddn_c(w) for c=0,1 and the transpose: 12 rows
    # (2c x 3i x 2 orientations); fold as two extra stacked factors
    LD = jnp.concatenate([-jnp.broadcast_to(Da2[None], (2, 3, 18))
                          .reshape(6, 18), -muDdn])
    RD = jnp.concatenate([muDdn, jnp.broadcast_to(Da2[None], (2, 3, 18))
                          .reshape(6, 18)])
    K = K + LD.T @ RD

    # ---- structured small blocks (no [18,18] intermediates) ---------------
    Cw = jnp.einsum("ijk,jc->cik", E3, wt)            # [2, 3, 3] C(wt_c)
    # n2-rule vector (atoms B and F): z . (v0 x w1 + w0 x v1)
    zt = -(yv - ya2 * a2) / nn - rho_b * a2
    Cz = cxm(zt)
    z33 = jnp.zeros((3, 3), dtype=dt)
    # geometric membrane Nb delta_ij + n2-rule, interleaved over (c, d)
    Kgg = jnp.concatenate([
        jnp.concatenate([Nb[0, 0] * I3, Nb[0, 1] * I3 - Cz], 1),
        jnp.concatenate([Nb[1, 0] * I3 - Cz.T, Nb[1, 1] * I3], 1)],
        0).reshape(2, 3, 2, 3).transpose(1, 0, 3, 2).reshape(6, 6)
    # atom A cross-product blocks: [3,2,3,2,2] g-h and h-g layouts
    Cw0, Cw1 = Cw[0], Cw[1]
    # Kgh[j, e, k, a, c]: nonzero at (e=0, a=1, c) -> -Cw_c and
    # (e=1, a=0, c) -> -Cw_c^T
    Kgh = jnp.stack([
        jnp.stack([jnp.stack([z33, z33], -1),            # e=0, a=0
                   jnp.stack([-Cw0, -Cw1], -1)], 2),     # e=0, a=1
        jnp.stack([jnp.stack([-Cw0.T, -Cw1.T], -1),      # e=1, a=0
                   jnp.stack([z33, z33], -1)], 2)], 1)
    Kgh = Kgh.reshape(3, 2, 3, 2, 2).reshape(6, 12)
    top = jnp.concatenate([Kgg, Kgh], -1)                      # [6, 18]
    bot = jnp.concatenate([Kgh.T, jnp.zeros((12, 12), dtype=dt)], -1)
    K = K + jnp.concatenate([top, bot], 0)
    return jnp.pad(K, ((3, 0), (3, 0)))


def svk_psi_surface(ctx, y, E_mod, nu, h_th):
    """St. Venant-Kirchhoff Kirchhoff-Love shell energy per unit reference
    midsurface area, integrated analytically through the thickness
    (membrane + bending; the formulation of dynamic-tspline.py:135-212).

    Uses the local-Cartesian membrane strain epsilon and curvature change
    kappa; psi = 1/2 (h A : eps : eps + h^3/12 A : kappa : kappa) with the
    plane-stress elasticity tensor A.

    If ``ctx.aux['shell_ref']`` is present (precompute_shell_reference),
    the reference-configuration geometry is read instead of recomputed.
    """
    if ctx.aux is not None and "shell_ref" in ctx.aux:
        sref = ctx.aux["shell_ref"]
        ref_a, ref_b, ea = sref.a, sref.b, sref.ea
    else:
        ref = midsurface_geometry(ctx)
        ref_a, ref_b = ref.a, ref.b
        ea = cartesian_frame_matrix(ref.a, ref.a0, ref.a1)
    cur = midsurface_geometry(ctx, y)
    eps_flat = 0.5 * (cur.a - ref_a)
    kappa_flat = cur.b - ref_b
    eps = ea @ eps_flat @ ea.T
    kappa = ea @ kappa_flat @ ea.T

    lam_ps = E_mod * nu / (1.0 - nu ** 2)  # plane-stress lambda
    mu = E_mod / (2.0 * (1.0 + nu))

    def contract(S):
        trS = jnp.trace(S)
        return lam_ps * trS ** 2 + 2.0 * mu * jnp.sum(S * S)

    return 0.5 * (h_th * contract(eps)
                  + h_th ** 3 / 12.0 * contract(kappa))
