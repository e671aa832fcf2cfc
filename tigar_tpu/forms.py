"""Pointwise form language: 2-jets of fields + geometric context.

The reference describes PDEs in UFL and lets FFC differentiate the extracted
FE basis symbolically (tIGAr/calculusUtils.py, common.py:1022-1139).  Here a
form is a plain JAX function of a quadrature-point context ``ctx`` and field
jets ``u``/``v``; it returns the *physical* integrand density at that point.
The assembler vmaps the density over all (element, quadrature-point) pairs
and obtains residual vectors / tangent actions by automatic differentiation
(see ops/assembly.py).

A field is represented at a point by its 2-jet in parametric coordinates:
value, parametric gradient, parametric Hessian.  All physical differential
operators (grad/div/curl/Hessian/Laplacian) are evaluated by exact chain
rule through the (rational) geometry mapping F -- this replaces UFL's
``cartesianGrad``/``cartesianDiv``/``cartesianCurl`` and the pushforwards of
calculusUtils.py:255-346.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Any

import jax.numpy as jnp


class Jet(NamedTuple):
    """2-jet of a (possibly vector-valued) field in parametric coordinates.

    val : []  or [m]
    g   : [d] or [m, d]      parametric gradient
    h   : [d,d] or [m,d,d]   parametric Hessian (None if not tabulated)

    Linear arithmetic acts jet-wise (jets form a vector space), which makes
    time-integrator linear combinations (timeIntegration.py) work directly
    on jets.
    """
    val: Any
    g: Any
    h: Optional[Any] = None

    def _zip(self, other, op):
        if isinstance(other, Jet):
            h = None
            if self.h is not None and other.h is not None:
                h = op(self.h, other.h)
            return Jet(op(self.val, other.val), op(self.g, other.g), h)
        raise TypeError("Jet arithmetic requires another Jet; "
                        "scale with * for scalars")

    def __add__(self, other):
        return self._zip(other, lambda a, b: a + b)

    def __radd__(self, other):
        if other == 0:  # support sum()
            return self
        return self.__add__(other)

    def __sub__(self, other):
        return self._zip(other, lambda a, b: a - b)

    def __neg__(self):
        return self * (-1.0)

    def __mul__(self, c):
        return Jet(self.val * c, self.g * c,
                   None if self.h is None else self.h * c)

    __rmul__ = __mul__

    def __truediv__(self, c):
        return self * (1.0 / c)

    def __getitem__(self, i):
        """Component extraction for vector-valued jets."""
        return Jet(self.val[i], self.g[i],
                   None if self.h is None else self.h[i])


class PhysField(NamedTuple):
    """A field already expressed in physical space: value and physical
    gradient (e.g. the result of an RT/N pushforward).  ``div_exact`` may
    carry an exactly-conservative divergence (Piola identity)."""
    val: Any
    grad: Any
    div_exact: Optional[Any] = None

    def __add__(self, other):
        de = None
        if self.div_exact is not None and other.div_exact is not None:
            de = self.div_exact + other.div_exact
        return PhysField(self.val + other.val, self.grad + other.grad, de)

    def __sub__(self, other):
        return self.__add__(other * (-1.0))

    def __mul__(self, c):
        return PhysField(self.val * c, self.grad * c,
                         None if self.div_exact is None else self.div_exact * c)

    __rmul__ = __mul__


class QP(NamedTuple):
    """Geometric context at one quadrature point.

    xi   : [d]       parametric coordinates
    x    : [nsd]     physical coordinates (F = P/w)
    w    : []        control weight function value
    wg   : [d]       parametric gradient of the weight
    wh   : [d,d]     parametric Hessian of the weight (or None)
    DF   : [nsd,d]   Jacobian of the geometry mapping
    d2F  : [nsd,d,d] second parametric derivatives of F (or None)
    g    : [d,d]     metric DF^T DF     (calculusUtils.py:18-24)
    ginv : [d,d]     inverse metric
    sqrtJ: []        sqrt(det g) volume Jacobian (calculusUtils.py:65-69)
    pinv : [d,nsd]   Moore-Penrose pseudo-inverse of DF (calculusUtils.py:56-63)
    nref : [d]       outward reference normal (boundary points only)
    normal:[nsd]     unit physical normal (boundary points only)
    surfJ: []        surface Jacobian (boundary points; calculusUtils.py:71-80)
    """
    xi: Any
    x: Any
    w: Any
    wg: Any
    wh: Optional[Any]
    DF: Any
    d2F: Optional[Any]
    g: Any
    ginv: Any
    sqrtJ: Any
    pinv: Any
    nref: Optional[Any] = None
    normal: Optional[Any] = None
    surfJ: Optional[Any] = None
    aux: Optional[Any] = None
    """Optional dict of precomputed per-point quantities attached by
    model-specific preprocessors (e.g. the Kirchhoff-Love reference-surface
    frame from models/shell.py precompute_shell_reference) -- geometry-only
    work hoisted out of the per-assembly density (sqrt/div are the costly
    pointwise operations)."""

    # ---- differential operators (physical space) --------------------------

    def grad(self, u):
        """Physical gradient: scalar jet -> [nsd]; vector jet [m] -> [m,nsd];
        PhysField -> its stored gradient.
        (reference: cartesianGrad, calculusUtils.py:255-267)"""
        if isinstance(u, PhysField):
            return u.grad
        return jnp.tensordot(u.g, self.pinv, axes=[[-1], [0]])

    def div(self, u):
        """Physical divergence of a vector field
        (reference: cartesianDiv, calculusUtils.py:269-276)."""
        if isinstance(u, PhysField) and u.div_exact is not None:
            return u.div_exact
        G = self.grad(u)
        return jnp.trace(G) if G.ndim == 2 else jnp.sum(
            jnp.diagonal(G, axis1=-2, axis2=-1), axis=-1)

    def curl(self, u):
        """Physical curl (reference: cartesianCurl, calculusUtils.py:278-302):
        3D vector -> vector; 2D vector -> scalar; 2D scalar -> vector."""
        G = self.grad(u)
        if G.ndim == 1:       # scalar in 2D: rotated gradient
            return jnp.stack([-G[1], G[0]])
        m = G.shape[0]
        if m == 3:
            return jnp.stack([G[2, 1] - G[1, 2],
                              G[0, 2] - G[2, 0],
                              G[1, 0] - G[0, 1]])
        if m == 2:
            return G[1, 0] - G[0, 1]
        raise ValueError("unsupported dimension for curl")

    def hess(self, u):
        """Physical (tangential) Hessian of a scalar or vector jet:
        H satisfies  u_,cd = DF^T H DF + grad_x(u) . d2F.
        Requires second-derivative tabulation (d2F / jet Hessians)."""
        if u.h is None or self.d2F is None:
            raise ValueError("hess() requires derivative order 2 "
                             "(construct the spline with nders=2)")
        gphys = self.grad(u)  # [nsd] or [m,nsd]
        corr = jnp.tensordot(gphys, self.d2F, axes=[[-1], [0]])
        M = u.h - corr        # [...,d,d]
        return jnp.einsum("...cd,ck,dl->...kl", M, self.pinv, self.pinv)

    def lap(self, u):
        """Physical Laplacian: trace of the physical Hessian (equals
        div(grad(u)) for co-dimension zero, the composition used in the
        reference demos, e.g. biharmonic.py:103-104)."""
        H = self.hess(u)
        return jnp.trace(H) if H.ndim == 2 else jnp.sum(
            jnp.diagonal(H, axis1=-2, axis2=-1), axis=-1)

    def parametric_grad(self, u):
        """Gradient in parametric coordinates
        (reference: ExtractedSpline.parametricGrad, common.py:1057-1062)."""
        return u.g

    # ---- rational splines ---------------------------------------------------

    def rationalize(self, u):
        """Divide a homogeneous-representation jet by the control weight
        function, with exact quotient rule for gradient and Hessian
        (reference: ExtractedSpline.rationalize, common.py:1134-1139)."""
        w, dw, d2w = self.w, self.wg, self.wh
        val = u.val / w
        g = (u.g - _outer_last(val, dw)) / w
        h = None
        if u.h is not None and d2w is not None:
            # d2(u/w) = (d2u - d(u/w) (x) dw - dw (x) d(u/w) - (u/w) d2w)/w
            t1 = g[..., :, None] * dw  # [..., d, d]
            t2 = jnp.swapaxes(t1, -1, -2)
            t3 = val[..., None, None] * d2w if jnp.ndim(val) else val * d2w
            h = (u.h - t1 - t2 - t3) / w
        return Jet(val, g, h)

    # ---- compatible-spline pushforwards ------------------------------------

    def pushforward_RT(self, u):
        """Div-conserving (Piola) pushforward of a parametric vector jet
        (reference: cartesianPushforwardRT, calculusUtils.py:320-336).
        Returns a PhysField with exact Piola divergence."""
        J = self.sqrtJ
        val = self.DF @ u.val / J
        div_exact = jnp.trace(u.g) / J
        grad = None
        if self.d2F is not None:
            # d_c val = (d2F[:,k,c] u_k + DF du_,c)/J - val dJ_c / J
            dJ = self._dsqrtJ()
            dval = (jnp.einsum("kic,i->kc", self.d2F, u.val)
                    + self.DF @ u.g) / J - val[:, None] * dJ[None, :] / J
            grad = dval @ self.pinv
        return PhysField(val, grad, div_exact)

    def pushforward_N(self, u):
        """Curl-conserving pushforward DF^{-T} u (3D, co-dimension zero;
        reference: cartesianPushforwardN, calculusUtils.py:307-318)."""
        from .ops.smallmat import inv_small
        DFinvT = inv_small(self.DF.T)
        val = DFinvT @ u.val
        grad = None
        if self.d2F is not None:
            # d_c (DF^{-T}) = -DF^{-T} d_c(DF^T) DF^{-T}
            dDFT = jnp.transpose(self.d2F, (1, 0, 2))  # [d, nsd, c] -> (DF^T)_{ik,c}
            dval = (DFinvT @ u.g
                    - jnp.einsum("ij,jkc,kl,l->ic", DFinvT, dDFT, DFinvT, u.val))
            grad = dval @ self.pinv
        return PhysField(val, grad)

    def pushforward_W(self, phi):
        """Mass-conserving pushforward phi / sqrt(det g)
        (reference: cartesianPushforwardW, calculusUtils.py:338-346)."""
        return phi.val / self.sqrtJ if isinstance(phi, Jet) else phi / self.sqrtJ

    # ---- internals -----------------------------------------------------------

    def _dsqrtJ(self):
        """Parametric gradient of sqrt(det g), from d2F."""
        dg = jnp.einsum("kce,kb->cbe", self.d2F, self.DF) + \
            jnp.einsum("kc,kbe->cbe", self.DF, self.d2F)
        tr = jnp.einsum("cb,cbe->e", self.ginv, dg)
        return 0.5 * self.sqrtJ * tr

    def dmetric(self):
        """Parametric derivative of the metric: dg[c,b,e] = d g_{cb}/d xi_e."""
        return (jnp.einsum("kce,kb->cbe", self.d2F, self.DF)
                + jnp.einsum("kc,kbe->cbe", self.DF, self.d2F))

    def christoffel(self):
        """Christoffel symbols Gamma^a_{dc} (first index raised), from the
        metric of the geometry mapping (reference: getChristoffel,
        calculusUtils.py:26-36)."""
        dg = self.dmetric()
        # Gamma^a_{dc} = 1/2 ginv[a,b] (dg[c,b,d] + dg[d,b,c] - dg[d,c,b])
        sym_part = (jnp.einsum("cbd->bdc", dg) + jnp.einsum("dbc->bdc", dg)
                    - jnp.einsum("dcb->bdc", dg))
        return 0.5 * jnp.einsum("ab,bdc->adc", self.ginv, sym_part)


def _outer_last(a, b):
    """outer product appending b's axis to a: a[...] , b[d] -> a[..., d]"""
    return a[..., None] * b


def taylor_eval(val, g, h, delta):
    """Evaluate the 2-jet (val, g, h) as a truncated Taylor polynomial at
    parametric offset ``delta``.  Differentiating the result with jax.jacfwd
    at delta=0 recovers exact first (and, nested, second) parametric
    derivatives of arbitrary compositions -- the AD replacement for UFL's
    symbolic ``grad`` chains (e.g. parametricGrad of a unit normal in the
    Kirchhoff-Love shell demos, kl-hyper.py:99-115)."""
    out = val + jnp.tensordot(g, delta, axes=[[-1], [0]])
    if h is not None:
        out = out + 0.5 * jnp.einsum("...cd,c,d->...", h, delta, delta)
    return out


def jet_fn(u):
    """Return the Taylor-polynomial function of parametric offset for a Jet."""
    return lambda delta: taylor_eval(u.val, u.g, u.h, delta)


def geometry_fn(ctx):
    """Taylor-polynomial function of parametric offset for the geometry
    mapping F (exact to second order when d2F is tabulated)."""
    return lambda delta: taylor_eval(ctx.x, ctx.DF, ctx.d2F, delta)


def deriv(f, u, v):
    """Gateaux derivative of ``f`` at jet(-pytree) ``u`` in direction ``v``:
    d/d(eps) f(u + eps v) at eps = 0, via JVP.  The pointwise analog of
    UFL ``derivative(form, u, v)`` (used at kl-hyper.py:220,237,
    dynamic-tspline.py:220,255)."""
    import jax
    return jax.jvp(f, (u,), (v,))[1]


def _zero_test_jet(u):
    """Zero Jet with the structure of the unknown's jet (the test-function
    structure of an equal-order space)."""
    uu = u["u"] if isinstance(u, dict) else u
    import jax
    return jax.tree_util.tree_map(jnp.zeros_like, uu)


def adjoint_of(density):
    """Adjoint-jet form of a residual density: returns a callable
    ``adj(ctx, u[, params]) -> Jet F`` with
    ``density(ctx, u, v) == sum(F.val*v.val) + sum(F.g*v.g) + sum(F.h*v.h)``
    for every test jet ``v`` (exact because residual densities are linear
    in the test jet).  Computed as the pointwise gradient with respect to a
    zero test jet -- AD stays at the quadrature point; the assembly-level
    contraction becomes an explicit einsum
    (ops/assembly.residual_vector_adjoint).  For hot densities, provide a
    hand-derived adjoint instead (models/shell.svk_shell_adjoint)."""
    import jax

    def adj(ctx, u, *params):
        v0 = _zero_test_jet(u)
        return jax.grad(lambda v: density(ctx, u, v, *params))(v0)

    return adj


# ---- UFL-flavoured helpers ---------------------------------------------------

def inner(a, b):
    """Full contraction of two equal-shape tensors (UFL ``inner``)."""
    a = jnp.asarray(a)
    b = jnp.asarray(b)
    return jnp.sum(a * b)


def dot(a, b):
    return jnp.dot(a, b)


def outer(a, b):
    return jnp.outer(a, b)


def sym(A):
    return 0.5 * (A + A.T)


def tr(A):
    return jnp.trace(A)


def cross(a, b):
    return jnp.cross(a, b)
