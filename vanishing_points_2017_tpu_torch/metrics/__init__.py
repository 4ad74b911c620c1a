from .auc import calc_auc  # noqa: F401
