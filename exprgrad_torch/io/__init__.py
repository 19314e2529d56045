"""IO of the port: model checkpoints, in the JAX package's file formats."""

from .serialize import (export_params_npz, import_params_npz, load_model,
                        save_model)

__all__ = ["export_params_npz", "import_params_npz", "load_model",
           "save_model"]
