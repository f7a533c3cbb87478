"""ADSALA core — the paper's contribution: ML-driven runtime selection of
BLAS L3 execution configs (paper: thread count; H100: the GEMM kernel's
tile).  The port's copy of the reference package's ``core``, numpy only.

Public surface:
    install_subroutine  — full install-time pipeline for one subroutine
    TunedSubroutine     — the persisted artifact (model + pipeline + knobs)
    AdsalaRuntime       — per-process runtime decision engine with memo cache
    ModelRegistry       — atomic JSON persistence
    subroutine_from_state — an artifact from a ``get_state()`` dict
    hopper_knob_space / block_knob_space / thread_knob_space — config spaces
    DistilledTree       — one tree fit to an ensemble's predictions
"""

from .features import (SUBROUTINES, SUBROUTINE_NDIMS, build_features,
                       feature_names, footprint_words)
from .halton import halton_sequence, sample_dims, scrambled_halton
from .knobs import (Knob, KnobSpace, block_knob_space, hopper_knob_space,
                    thread_knob_space)
from .dataset import TimingDataset, gather
from .preprocess import PreprocessPipeline, YeoJohnsonTransformer
from .fastpath import CompiledPredictor, compile_predictor
from .lof import lof_scores, remove_outliers
from .selection import ModelReport, evaluate_candidates, select_best
from .tuner import (TunedSubroutine, attach_knn_coreset, install_backend,
                    install_subroutine)
from .runtime import (AdsalaRuntime, BackendStats, BucketStats, RuntimeStats,
                      global_runtime)
from .registry import (ModelRegistry, load_subroutine, pack_state,
                       save_subroutine, subroutine_from_state, unpack_state)
from .distill import DistilledTree

__all__ = [
    "SUBROUTINES", "SUBROUTINE_NDIMS", "build_features", "feature_names",
    "footprint_words", "halton_sequence", "sample_dims", "scrambled_halton",
    "Knob", "KnobSpace", "block_knob_space", "hopper_knob_space",
    "thread_knob_space", "TimingDataset", "gather",
    "PreprocessPipeline", "YeoJohnsonTransformer", "CompiledPredictor",
    "compile_predictor", "lof_scores",
    "remove_outliers", "ModelReport", "evaluate_candidates", "select_best",
    "TunedSubroutine", "install_subroutine", "install_backend",
    "attach_knn_coreset",
    "AdsalaRuntime", "BackendStats", "BucketStats", "RuntimeStats",
    "global_runtime", "ModelRegistry", "load_subroutine", "pack_state",
    "save_subroutine", "subroutine_from_state", "unpack_state",
    "DistilledTree",
]
