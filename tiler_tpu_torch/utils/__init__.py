from .search import golden_ratio_search, powell_minimize  # noqa: F401
from .progress import StepTimer, trace_step  # noqa: F401
