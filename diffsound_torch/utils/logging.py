"""Experiment metric logging: JSONL stream (always) + TensorBoard when
available (the reference's SummaryWriter usage).  Counterpart of
`diffsound_tpu/utils/logging.py`."""

from __future__ import annotations

import json
import os
import time


class MetricLogger:
    def __init__(self, out_dir: str, name: str = "metrics"):
        os.makedirs(out_dir, exist_ok=True)
        self.path = os.path.join(out_dir, f"{name}.jsonl")
        self._fh = open(self.path, "a")
        self._tb = None
        try:  # optional TensorBoard
            from torch.utils.tensorboard import SummaryWriter  # type: ignore

            self._tb = SummaryWriter(out_dir)
        except ImportError:
            pass

    def scalar(self, tag: str, value, step: int):
        rec = {"t": time.time(), "tag": tag, "value": float(value), "step": int(step)}
        self._fh.write(json.dumps(rec) + "\n")
        self._fh.flush()
        if self._tb is not None:
            self._tb.add_scalar(tag, float(value), step)

    def scalars(self, values: dict, step: int):
        for tag, v in values.items():
            self.scalar(tag, v, step)

    def figure(self, tag: str, image_path: str, step: int):
        """Register a saved figure (TensorBoard add_image parity with the
        reference's add_figure, material_sync_train.py:187-195)."""
        rec = {"t": time.time(), "tag": tag, "image": image_path, "step": int(step)}
        self._fh.write(json.dumps(rec) + "\n")
        self._fh.flush()
        if self._tb is not None:
            try:
                import numpy as np
                from PIL import Image  # type: ignore

                img = np.asarray(Image.open(image_path).convert("RGB"))
                self._tb.add_image(tag, img, step, dataformats="HWC")
            except (ImportError, OSError):
                pass

    def close(self):
        self._fh.close()
        if self._tb is not None:
            self._tb.close()
