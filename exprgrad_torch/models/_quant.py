"""Weight-only int8 quantization helpers for the serving runtime.

The implementation lives in :mod:`exprgrad_torch.quant` (shared with
``Model.quantize_weights``, which also infers the scale axes from the
kernel IR); this module keeps the serving-local import path, as the JAX
package's ``models/_quant.py`` does.
"""

from ..quant import QuantW, dequantize, quantize_weight

__all__ = ["QuantW", "dequantize", "quantize_weight"]
