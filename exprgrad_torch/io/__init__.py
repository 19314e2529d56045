"""IO of the port: model checkpoints (in the JAX package's file formats),
checkpoint rotation, dataset iteration and formats (IDX, PPM, CSV, JSON),
and text tokenization (byte-level BPE)."""

from .tokenizer import BPETokenizer
from .dataset import Batches, Prefetcher, fit_epochs
from .manager import CheckpointManager
from .serialize import (export_params_npz, import_params_npz, load_model,
                        load_program, save_model, save_program)
from .idx import load_idx, save_idx
from .ppm import load_ppm, save_ppm

__all__ = [
    "BPETokenizer",
    "Batches",
    "CheckpointManager",
    "Prefetcher",
    "fit_epochs",
    "export_params_npz",
    "import_params_npz",
    "load_idx",
    "load_model",
    "load_ppm",
    "load_program",
    "save_idx",
    "save_model",
    "save_ppm",
    "save_program",
]
