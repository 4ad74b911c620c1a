from .horizon import calculate_horizon_and_ortho_vp  # noqa: F401
from .em import expectation_maximisation, EMConfig, EMResult  # noqa: F401
