from .batch import BatchFitResult, evaluate_gamma, fit_spectra_batch

__all__ = ["BatchFitResult", "evaluate_gamma", "fit_spectra_batch"]
