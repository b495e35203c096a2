"""Structured per-step metrics and host logging (port of
``vit_tpu/utils/metrics.py``).

Train steps return a metrics dict of device tensors; :class:`MetricLogger`
queues them and reads them on the host only at :meth:`MetricLogger.flush`,
one synchronisation a flush rather than one a step, and writes one JSON line
a step with ``step`` and ``wall_s``.  Where ``torch.utils.tensorboard`` can
be imported, ``writer_dir`` also mirrors the scalars to a TensorBoard
writer; without it the logger goes on without one.
"""

from __future__ import annotations

import json
import sys
import time
from typing import Any, Dict, Optional

import torch


class MetricLogger:
    def __init__(self, every: int = 10, writer_dir: Optional[str] = None, stream=None):
        self.every = every
        self.stream = stream or sys.stderr
        self._pending: list[tuple[int, Dict[str, Any]]] = []
        self._t0 = time.time()
        self._writer = None
        if writer_dir is not None:
            try:
                from torch.utils.tensorboard import SummaryWriter

                self._writer = SummaryWriter(writer_dir)
            except Exception:
                self._writer = None

    def log(self, step: int, metrics: Dict[str, Any]) -> None:
        """Queue a metrics dict (device tensors fine: read at flush)."""
        self._pending.append((step, metrics))
        if step % self.every == 0:
            self.flush()

    def flush(self) -> None:
        if not self._pending:
            return
        firsts = [v.detach().reshape(-1)[0].float() for _, m in self._pending
                  for v in m.values() if isinstance(v, torch.Tensor)]
        # One transfer to the host for every queued tensor.
        values = iter(torch.stack([v.to(firsts[0].device) for v in firsts]).tolist()
                      if firsts else [])
        for step, metrics in self._pending:
            host = {k: next(values) if isinstance(v, torch.Tensor) else v
                    for k, v in metrics.items()}
            host["step"] = int(step)
            host["wall_s"] = round(time.time() - self._t0, 3)
            print(json.dumps(host), file=self.stream, flush=True)
            if self._writer is not None:
                for k, v in host.items():
                    if isinstance(v, (int, float)) and k != "step":
                        self._writer.add_scalar(k, v, step)
        self._pending.clear()
