"""Checkpoint and resume with ``torch.save``.

Counterpart of ``fieldconv_tpu/train/checkpoint.py`` (orbax there).  Each
checkpoint is one file ``step_<step>.pt`` holding the model's state_dict,
the optimizer state and the step.  A save writes a temporary file in the
same directory and renames it into place, so an interrupted save leaves
the previous checkpoints intact; the newest ``max_to_keep`` are kept.
"""

from __future__ import annotations

import os
import re
from typing import Optional

import torch

_NAME = re.compile(r"^step_(\d+)\.pt$")


class CheckpointManager:
    def __init__(self, directory: str, max_to_keep: int = 3):
        self.dir = os.path.abspath(directory)
        self.max_to_keep = max_to_keep
        os.makedirs(self.dir, exist_ok=True)

    def _steps(self):
        return sorted(int(m.group(1)) for f in os.listdir(self.dir)
                      if (m := _NAME.match(f)))

    def _path(self, step: int) -> str:
        return os.path.join(self.dir, f"step_{step:09d}.pt")

    def save(self, net, opt, step: int) -> None:
        """Write {model, opt, step} atomically, then drop all but the
        newest max_to_keep checkpoints."""
        path = self._path(step)
        tmp = f"{path}.tmp{os.getpid()}"
        torch.save({"model": net.state_dict(), "opt": opt.state_dict(),
                    "step": int(step)}, tmp)
        os.replace(tmp, path)
        for old in self._steps()[:-self.max_to_keep]:
            os.remove(self._path(old))

    def latest_step(self) -> Optional[int]:
        steps = self._steps()
        return steps[-1] if steps else None

    def restore(self, net, opt) -> Optional[int]:
        """Load the latest checkpoint into ``net`` and ``opt`` (on the
        device the model is on); returns its step, or None when there is
        none."""
        step = self.latest_step()
        if step is None:
            return None
        device = next(net.parameters()).device
        state = torch.load(self._path(step), map_location=device,
                           weights_only=True)
        net.load_state_dict(state["model"])
        opt.load_state_dict(state["opt"])
        return state["step"]
