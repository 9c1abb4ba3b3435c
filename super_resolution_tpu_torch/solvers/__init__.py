from super_resolution_tpu_torch.solvers.map_solver import (  # noqa: F401
    IRLSMapSolverOptions,
    MapSolverOptions,
)
from super_resolution_tpu_torch.solvers.irls import IRLSMapSolver, irls_solve_fused  # noqa: F401
from super_resolution_tpu_torch.solvers.admm import (  # noqa: F401
    AdmmSolver,
    AdmmSolverOptions,
)
from super_resolution_tpu_torch.solvers.least_squares import (  # noqa: F401
    MinimizeResult,
    minimize,
)
from super_resolution_tpu_torch.solvers.objective import (  # noqa: F401
    data_term_cost,
    data_term_cost_and_grad,
    data_term_cost_and_grad_static,
    finite_difference_grad,
    make_map_value_and_grad,
)
