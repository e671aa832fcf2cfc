"""Shell-residual assembly variants, f32: baseline (chunked vmap) vs
remat'd density vs unchunked.

Hunts device-memory-traffic reductions in the reverse-mode residual path
(ops/assembly.py element_residuals): remat recomputes the density forward
during the backward pass instead of storing intermediates.  No H100
measurement recorded yet.
"""

import os
import sys
import time
from functools import partial

import numpy as np


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def main():
    import jax
    here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    sys.path.insert(0, here)
    from tigar_tpu.config import configure_compilation_cache
    configure_compilation_cache()
    import jax.numpy as jnp
    import jax.tree_util as jtu

    from tigar_tpu.ops.knots import uniform_knots
    from tigar_tpu.models.bspline import ExplicitBSplineControlMesh
    from tigar_tpu.models.space import EqualOrderSpline
    from tigar_tpu.models.extracted import ExtractedSpline
    from tigar_tpu.models.shell import (svk_psi_surface,
                                        precompute_shell_reference)
    from tigar_tpu.forms import deriv

    nel = int(os.environ.get("BENCH_NEL", "128"))
    rep = int(os.environ.get("BENCH_REPS", "20"))
    p = 2
    cm = ExplicitBSplineControlMesh(
        [p, p], [uniform_knots(p, -1.0, 1.0, nel)] * 2, extra_dim=1)
    sp = EqualOrderSpline(3, cm)
    basis = cm.scalar_basis()
    for side in (0, 1):
        for direction in (0, 1):
            dofs = basis.side_dofs(direction, side, n_layers=2)
            for i in range(3):
                sp.add_zero_dofs(i, dofs)

    E_mod, nu, h_th, q = 1.0e7, 0.3, 0.03, 1.0e-2

    def res(ctx, u, v):
        dW = deriv(lambda y: svk_psi_surface(ctx, y, E_mod, nu, h_th), u, v)
        return dW - q * v.val[2]

    res_ckpt = jax.checkpoint(res)

    def make_asm(chunk):
        spline = precompute_shell_reference(ExtractedSpline(
            sp, quad_degree=2 * p, nders=2, assembly_chunk=chunk))
        asm = spline._assembler("dx")
        return jtu.tree_map(
            lambda x: x.astype(jnp.float32)
            if hasattr(x, "dtype") and jnp.issubdtype(x.dtype, jnp.floating)
            else x, asm), spline.ndof

    @partial(jax.jit, static_argnames=("rep", "density_id"))
    def chained(asm_, U, c, rep, density_id):
        density = [res, res_ckpt][density_id]

        def body(carry, _):
            r = asm_.residual_vector(density, U + jnp.asarray(1e-9, U.dtype)
                                     * carry)
            return (jnp.vdot(r, r) * 1e-30).astype(carry.dtype), None
        return jax.lax.scan(body, c, None, length=rep)[0]

    rng = np.random.default_rng(0)

    variants = [("baseline_chunk8192", 8192, 0),
                ("remat_chunk8192", 8192, 1),
                ("unchunked", 0, 0),
                ("remat_unchunked", 0, 1)]
    for name, chunk, did in variants:
        asm_, ndof = make_asm(chunk)
        U = jnp.asarray(rng.normal(size=ndof) * 1e-4, dtype=jnp.float32)
        c0 = jnp.zeros((), jnp.float32)
        t0 = time.time()
        try:
            float(chained(asm_, U, c0, rep=rep, density_id=did))
        except Exception as e:
            log(f"{name}: FAILED {type(e).__name__}: {str(e)[:200]}")
            continue
        log(f"{name}: compile+first {time.time() - t0:.1f}s")
        best = np.inf
        for i in range(2):
            t0 = time.time()
            float(chained(asm_, U, c0 + i, rep=rep, density_id=did))
            best = min(best, (time.time() - t0) / rep)
        log(f"{name}: {best * 1e3:.3f} ms ({ndof / best:.3e} DoF/s)")


if __name__ == "__main__":
    main()
