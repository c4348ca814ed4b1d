"""Training checkpoints (port of ``playground3d_tpu/utils/checkpoint.py``).

The reference checkpoints with ``torch.save(state_dict)`` per epoch
(train_detector_3D_angle.py:416-417). Here:

* model weights <-> the JAX package's flat npz (``models/nn.py``
  ``save_params`` / ``load_params``);
* the whole training state of a :class:`~playground3d_tpu_torch.train.
  trainer.Trainer` (weights, Adam's moments and step counts, the step, the
  learning rate and the plateau counters) with ``torch.save``, written to a
  temporary file in the same directory and renamed into place, so a run cut
  during a save leaves the previous checkpoint whole. The JAX package writes
  orbax directories, which this package does not read.
"""

from __future__ import annotations

import os
import re
from typing import List, Optional

import torch

__all__ = ["CheckpointManager", "load_train_state", "save_train_state"]


def save_train_state(path: str, trainer) -> None:
    """Write ``trainer``'s whole state to ``path`` (atomic: temporary file,
    then rename)."""
    from playground3d_tpu_torch.train.trainer import train_leaves

    state = {
        "leaves": {k: t.detach().cpu() for k, t in train_leaves(trainer.model).items()},
        "optimizer": trainer.opt.state_dict(),
        "step": trainer.state.step,
        "lr": trainer.lr,
        "best": trainer._best,
        "bad_epochs": trainer._bad_epochs,
        "history": list(trainer.history),
    }
    tmp = f"{path}.tmp-{os.getpid()}"
    try:
        torch.save(state, tmp)
        os.replace(tmp, path)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise


def load_train_state(path: str, like):
    """Restore a state written by :func:`save_train_state` into the Trainer
    ``like`` (same architecture); returns it. Raises unless the checkpoint
    holds exactly its leaves with their shapes."""
    from playground3d_tpu_torch.train.trainer import train_leaves

    state = torch.load(path, map_location="cpu", weights_only=True)
    leaves = train_leaves(like.model)
    if set(state["leaves"]) != set(leaves):
        missing, extra = sorted(set(leaves) - set(state["leaves"])), sorted(set(state["leaves"]) - set(leaves))
        raise ValueError(f"{path}: checkpoint does not match the model: missing {missing[:5]} extra {extra[:5]}")
    with torch.no_grad():
        for k, t in leaves.items():
            if tuple(state["leaves"][k].shape) != tuple(t.shape):
                raise ValueError(f"{path}: {k} has shape {tuple(state['leaves'][k].shape)}, the model {tuple(t.shape)}")
            t.copy_(state["leaves"][k])
    like.opt.load_state_dict(state["optimizer"])  # Adam's moments, counts and learning rate
    like.state = like.state._replace(step=int(state["step"]))
    like.lr = float(state["lr"])
    like._best = float(state["best"])
    like._bad_epochs = int(state["bad_epochs"])
    like.history = list(state["history"])
    return like


class CheckpointManager:
    """Rotating checkpoints ``<directory>/step_<n>.pt``, keeping the latest
    ``keep``."""

    _NAME = re.compile(r"^step_(\d+)\.pt$")

    def __init__(self, directory: str, keep: int = 3):
        self.directory = os.path.abspath(directory)
        self.keep = keep
        os.makedirs(self.directory, exist_ok=True)

    def steps(self) -> List[int]:
        found = (self._NAME.match(n) for n in os.listdir(self.directory))
        return sorted(int(m.group(1)) for m in found if m)

    def path(self, step: int) -> str:
        return os.path.join(self.directory, f"step_{step}.pt")

    def save(self, step: int, trainer) -> None:
        save_train_state(self.path(step), trainer)
        for old in self.steps()[: -self.keep]:
            os.unlink(self.path(old))

    def latest_step(self) -> Optional[int]:
        steps = self.steps()
        return steps[-1] if steps else None

    def restore(self, like, step: Optional[int] = None):
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoint in {self.directory}")
        return load_train_state(self.path(step), like)
