"""Global configuration for tigar_tpu.

Analog of the module-level constants in the reference
(tIGAr/common.py:43-84).  The reference configures PETSc/MPI at import; we
configure JAX (x64 mode, matmul precision) and numeric tolerances here.

Accuracy targets for IGA verification (optimal convergence rates, <=1e-10
relative L2 errors) are unreachable in float32, so float64 is the default
solve/assembly dtype.  The production Newton drivers run their bulk phase
in f32 and polish in f64 (solvers/newton_stencil.py).
"""

import os

import jax

# Enable x64 unless explicitly disabled via environment.
if os.environ.get("TIGAR_X64", "1") != "0":
    jax.config.update("jax_enable_x64", True)

# Precision policy: every f32 matmul/einsum/dot runs in full f32.  On a GPU
# the default precision may lower f32 products to TF32 (about three decimal
# digits), which silently corrupts penalty-scaled tangent builds and the
# Krylov operators; "highest" makes the device compute what the CPU tests
# check.  Whether TF32 may be used in the f32 production phase is a
# measured question, not a default.
jax.config.update("jax_default_matmul_precision", "highest")

# Root of the source checkout (the directory holding the package).
CHECKOUT_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def configure_compilation_cache(root=CHECKOUT_ROOT):
    """Place JAX's persistent compilation cache; returns its directory.

    The one place in the code that sets the cache directory.  When
    ``JAX_COMPILATION_CACHE_DIR`` is set, JAX has already read it and
    nothing is overridden; otherwise the cache goes to
    ``<root>/.jax_cache`` (a fixed path, so later runs hit it)."""
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    path = os.path.join(root, ".jax_cache")
    jax.config.update("jax_compilation_cache_dir", path)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)
    return path

import jax.numpy as jnp  # noqa: E402  (after x64 config)
import numpy as np  # noqa: E402

# Index dtype for connectivity / DoF arrays (reference: INDEX_TYPE='int32',
# common.py:43).  int32 indexing is also what XLA gathers/scatters prefer.
INDEX_TYPE = np.int32

# Default real dtype for assembly and solves.
DEFAULT_REAL_TYPE = jnp.float64 if jax.config.read("jax_enable_x64") else jnp.float32

# Basis values smaller than this are dropped when building explicit sparse
# extraction operators (reference: DEFAULT_BASIS_FUNC_IGNORE_EPS=1e-15,
# common.py:56-60 -- raised from 1e-9 because biharmonic convergence degraded).
DEFAULT_BASIS_FUNC_IGNORE_EPS = 1e-15

# Tolerance used when comparing knots for equality: 100*eps ~ 2.2e-14
# absolute.  (The reference uses 10*DOLFIN_EPS ~ 3e-15, BSplines.py:40-42;
# we keep one extra order of headroom because knot arithmetic here runs
# through batched normalization/refinement rather than one-off scalars.)
KNOT_NEAR_EPS = 100.0 * np.finfo(np.float64).eps

# Elements per assembly chunk for large problems.  Assembly maps a
# per-element kernel over the Bezier-element batch; beyond this many
# elements the map runs in lax.map chunks so the per-point jet
# intermediates (which XLA pads heavily for small trailing dims) peak at
# one chunk, not the whole batch.  None/0 disables chunking.  The value
# was sized for a 16 GB device; re-sizing for 80 GB is an open question.
DEFAULT_ASSEMBLY_CHUNK = int(os.environ.get("TIGAR_ASSEMBLY_CHUNK", 8192))

# Default Newton solver parameters (reference: common.py:1292-1302).
DEFAULT_MAX_ITERS = 20
DEFAULT_RELATIVE_TOLERANCE = 1e-5

# Default penalty for the iterated div-free solver (reference:
# compatibleSplines.py:19).
DEFAULT_RT_PENALTY = 1e1


def real_dtype():
    """Current default floating dtype as a numpy dtype."""
    return np.dtype(np.float64 if jax.config.read("jax_enable_x64") else np.float32)
