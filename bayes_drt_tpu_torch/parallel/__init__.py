from .batch import (BatchFitResult, drift_fit_spectra_batch, evaluate_gamma,
                    fit_spectra_batch, fit_spectra_ragged, predict_Z_batch,
                    ridge_fit_spectra_batch)

__all__ = ["BatchFitResult", "drift_fit_spectra_batch", "evaluate_gamma",
           "fit_spectra_batch", "fit_spectra_ragged", "predict_Z_batch",
           "ridge_fit_spectra_batch"]
