"""Matrix-free high-order FEM framework with fast hanging-node
constraints — same capabilities as the reference benchmark suite for
"Efficient application of hanging-node constraints for matrix-free high-order
FEM computations on CPU and GPU" (Munch, Ljungkvist, Kronbichler, 2022), but
designed for JAX / XLA on GPUs and device meshes.

Quick start::

    import dealii_matrixfree_hanging_nodes as mfhn

    tria = mfhn.create_quadrant(dim=3, n_refinements=4)
    mf = mfhn.MatrixFree(tria, degree=4, dtype="float64")
    op = mfhn.LaplaceOperator(mf)
    dst = op.vmult(src)
"""

from .utils.hostmem import tune_host_memory as _tune_host_memory

_tune_host_memory()

from .version import __version__  # noqa: F401
from .elements import ShapeInfo, shape_info  # noqa: F401
from .mesh import (  # noqa: F401
    Triangulation,
    create_annulus,
    create_geometry,
    create_quadrant,
    create_quadrant_flexible,
    create_step,
    create_uniform,
)

__all__ = [
    "__version__",
    "ShapeInfo",
    "shape_info",
    "Triangulation",
    "create_annulus",
    "create_geometry",
    "create_quadrant",
    "create_quadrant_flexible",
    "create_step",
    "create_uniform",
]


def _register_extras():
    """Late imports that depend on the full stack; keeps base import light."""
    global DoFHandler, ConstraintInfo, MatrixFree, LaplaceOperator
    from .dof_handler import DoFHandler  # noqa: F401
    from .constraints import ConstraintInfo  # noqa: F401
    from .matrix_free import MatrixFree  # noqa: F401
    from .models.laplace import LaplaceOperator  # noqa: F401


try:  # pragma: no cover - during incremental bring-up some modules may be absent
    _register_extras()
except ImportError:
    pass
