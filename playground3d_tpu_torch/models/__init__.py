"""The detector's public functions, as the JAX package's ``models``
exports them. Each is loaded at its first use (PEP 562): ``ops`` modules
import ``models.nn``, and an eager import of ``models.retinanet`` here would
close a cycle through ``models.quant`` -> ``ops.qconv``."""

import importlib

_EXPORTS = {
    "anchors_for_shape": "anchors",
    "num_anchors_for_shape": "anchors",
    "decode_regression": "decode",
    "Detections": "retinanet",
    "detect_multiframe": "retinanet",
    "detect_singleframe": "retinanet",
    "forward_raw": "retinanet",
    "localize": "retinanet",
    "retinanet_init": "retinanet",
    "load_params": "nn",
    "save_params": "nn",
}

__all__ = list(_EXPORTS)


def __getattr__(name):
    if name in _EXPORTS:
        return getattr(importlib.import_module(f"{__name__}.{_EXPORTS[name]}"), name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
