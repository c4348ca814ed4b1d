# A frozen copy of the port's __init__.py, the benchmark's plain reference: the plain
# PyTorch paths only, no kernel launch and no import of the port.
"""PyTorch + CUDA port of ``playground3d_tpu`` for NVIDIA Hopper.

The JAX package stays the reference; this package mirrors its module paths
(``models/resnet.py`` <-> ``models/resnet.py`` ...) and imports neither JAX
nor anything of ``playground3d_tpu``.

Float settings are stated once, here: the geometry and Kalman-filter math
is float32 end to end (the JAX package pins ``Precision.HIGHEST`` for its
geometry einsums), so TF32 is off for both matmuls and cuDNN convolutions.
"""

from __future__ import annotations

from typing import Union

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

DeviceLike = Union[str, torch.device, None]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """The device an entry point runs on: the card unless the caller asks
    for the CPU. Raises when CUDA is asked for (explicitly or by default)
    and absent — nothing falls back to the CPU quietly."""
    dev = torch.device("cuda") if device is None else torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "cellbench.reference: CUDA device requested but "
            "torch.cuda.is_available() is False; pass device='cpu' to run "
            "on the CPU"
        )
    return dev
