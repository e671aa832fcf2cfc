"""Measure the assembled-stencil tangent path on the device at bench
scale: K-route element-matrix build (ops/assembly.element_matrices_adjoint),
stencil assembly (ops/stencil), stencil apply -- the operator pipeline for
the MG-preconditioned production Newton step.

Timing: python-level chains of dependent jitted calls ending in a scalar
fetch (bench.py docstring)."""
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np
import jax

from tigar_tpu.config import configure_compilation_cache

configure_compilation_cache()

import jax.numpy as jnp

from tigar_tpu.ops.knots import uniform_knots
from tigar_tpu.models.bspline import ExplicitBSplineControlMesh
from tigar_tpu.models.space import EqualOrderSpline
from tigar_tpu.models.extracted import ExtractedSpline
from tigar_tpu.models.shell import (precompute_shell_reference,
                                    svk_shell_adjoint)
from tigar_tpu.ops.stencil import stencil_from_element_matrices


def log(*a):
    print(*a, file=sys.stderr, flush=True)


nel = int(os.environ.get("BENCH_NEL", "128"))
p = 2
kvecs = [uniform_knots(p, -1.0, 1.0, nel)] * 2
cm = ExplicitBSplineControlMesh([p, p], kvecs, extra_dim=1)
sp = EqualOrderSpline(3, cm)
basis = cm.scalar_basis()
for side in (0, 1):
    for direction in (0, 1):
        dofs = basis.side_dofs(direction, side, n_layers=2)
        for i in range(3):
            sp.add_zero_dofs(i, dofs)
spline = precompute_shell_reference(
    ExtractedSpline(sp, quad_degree=2 * p, nders=2))
asm32 = spline._assembler("dx").astype(jnp.float32)
scal = spline.space.fields[0]
ndof = spline.ndof
log(f"ndof={ndof} nel={asm32.nel} chunk={asm32.chunk}")

E, nu, h, q = 1.0e7, 0.3, 0.03, 1e-2


def res_adj(ctx, u):
    F = svk_shell_adjoint(ctx, u, E, nu, h)
    return F._replace(val=F.val.at[2].add(-q))


@jax.jit
def build_stencil(asm_, U, c):
    Em = asm_.element_matrices_adjoint(
        res_adj, U + jnp.asarray(1e-9, U.dtype) * c)
    st = stencil_from_element_matrices(scal, Em, nf=3)
    return st, (jnp.vdot(st.S.reshape(-1)[:8], st.S.reshape(-1)[:8])
                * 1e-30).astype(c.dtype)


@jax.jit
def apply_stencil(st, W, c):
    out = st(W + jnp.asarray(1e-9, W.dtype) * c)
    return (jnp.vdot(out, out) * 1e-30).astype(c.dtype)


rng = np.random.default_rng(0)
U = jnp.asarray(rng.normal(size=ndof) * 1e-4, dtype=jnp.float32)
W = jnp.asarray(rng.normal(size=ndof) * 1e-4, dtype=jnp.float32)

c = jnp.zeros((), jnp.float32)
t0 = time.time()
st, c = build_stencil(asm32, U, c)
float(c)
log(f"stencil build compile+first: {time.time() - t0:.1f}s")
rep = 5
t0 = time.time()
for _ in range(rep):
    st, c = build_stencil(asm32, U, c)
float(c)
log(f"stencil build: {(time.time() - t0) / rep * 1e3:.2f} ms")

t0 = time.time()
c = apply_stencil(st, W, c)
float(c)
log(f"stencil apply compile+first: {time.time() - t0:.1f}s")
rep = 50
t0 = time.time()
for _ in range(rep):
    c = apply_stencil(st, W, c)
float(c)
log(f"stencil apply: {(time.time() - t0) / rep * 1e3:.3f} ms "
    f"({ndof / ((time.time() - t0) / rep):.3e} DoF/s)")
