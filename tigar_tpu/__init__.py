"""tigar_tpu: an isogeometric analysis (IGA) framework in JAX.

Re-designed from scratch with the capability surface of tIGAr
(github.com/david-kamensky/tIGAr): B-spline / NURBS / multi-patch /
T-spline / div- and curl-conforming compatible-spline discretizations of
PDEs, with batched Bezier-element quadrature assembly, autodiff-derived
residuals and tangents, matrix-free Krylov solvers, and GSPMD sharding over
device meshes replacing the reference's FEniCS/PETSc/MPI substrate.
"""

from . import config  # noqa: F401  (configures x64 at import)

from .ops.knots import (uniform_knots, KnotVector,  # noqa: F401
                        ij2dof, ijk2dof, dof2ij, dof2ijk)
from .ops.quadrature import gauss_rule, gauss_rule_interval  # noqa: F401
from .ops.refine import insert_knot, refine_axis, uniform_refine  # noqa: F401
from .models.bspline import (TensorBSplineBasis, ScalarBasis,  # noqa: F401
                             ControlMesh, ExplicitBSplineControlMesh)
from .models.nurbs import NURBSControlMesh  # noqa: F401
from .models.multipatch import (MultiPatchBSplineBasis,  # noqa: F401
                                MultiPatchControlMesh,
                                read_legacy_multipatch, MergedBasis,
                                merge_coincident_dofs, MergedControlMesh)
from .models.tsplines import (TSplineBasis, RhinoTSplineControlMesh,  # noqa: F401
                              bspline_to_rhino_extraction)
from .models.space import (SplineSpace, EqualOrderSpline,  # noqa: F401
                           FieldListSpline)
from .models.compatible import (BSplineCompat, generate_fields_compat,  # noqa: F401
                                IteratedPenaltySolver,
                                iterated_div_free_solve, div_free_project,
                                piola_div)
from .models.extracted import ExtractedSpline  # noqa: F401
from .models import shell  # noqa: F401
from .forms import (Jet, PhysField, QP, inner, dot, outer, sym, tr,  # noqa: F401
                    cross, deriv, taylor_eval)
from .timeint import (BackwardEulerIntegrator, LoadStepper,  # noqa: F401
                      GeneralizedAlphaIntegrator,
                      LinearDGSpaceTimeIntegrator, x_alpha)
from .calculus import (CurvilinearTensor, curvilinear_inner,  # noqa: F401
                       covariant_derivative, curvilinear_grad,
                       curvilinear_div, spline_GRAD, spline_DIV)
from .contact import PointContact  # noqa: F401
from .coupling import (PenaltyInterfaceCoupling,  # noqa: F401
                       NitscheInterfaceCoupling, ShellInterfaceCoupling)
from .interface import (InterfaceForm, EnergyNitscheCoupling,  # noqa: F401
                        phys_grad)
from .io import (write_extraction, read_extraction, write_vtk,  # noqa: F401
                 write_pvd, save_state, load_state)
from .ops.sumfac import (make_sumfac_operator,  # noqa: F401
                         make_sumfac_identity_operator,
                         sumfac_linear_form, sumfac_l2_error)
from .solvers.refinement import refine_solve  # noqa: F401
from .solvers.multigrid import (Multigrid, coarsen_knots,  # noqa: F401
                                insertion_matrix_1d)
from .solvers.eigen import (generalized_eigh, smallest_modes,  # noqa: F401
                            lobpcg_smallest)
from .solvers.newton_stencil import StencilNewton  # noqa: F401
from .solvers.newton_stencil_mp import MultiPatchStencilNewton  # noqa: F401
from .solvers.newton_sa import SANewton  # noqa: F401
from .solvers.aggregation import TwoLevelSA, MultilevelSA  # noqa: F401

__version__ = "0.1.0"
