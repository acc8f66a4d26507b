"""Scalar metrics to ``metrics.jsonl`` (and TensorBoard where it imports),
and the ``TEST.EXPECTED_RESULTS`` regression check.

Port of ``diffusionvid_tpu/utils/metrics_io.py`` (the reference's
TensorBoard writer, ``tools/train_net.py:93-97``, ``engine/trainer.py:173-182``:
Train/loss*, Val/mAP scalars, purged after the step a run resumes from).
"""

from __future__ import annotations

import json
import os
import time
from typing import Optional


class MetricsWriter:
    """Appends one JSON record a call to ``output_dir/metrics.jsonl``.  With
    ``resume_step`` it first drops the records of later steps, which the
    resumed run writes again."""

    def __init__(self, output_dir: str, resume_step: Optional[int] = None):
        os.makedirs(output_dir, exist_ok=True)
        self.path = os.path.join(output_dir, "metrics.jsonl")
        if resume_step is not None and os.path.exists(self.path):
            kept = []
            with open(self.path) as f:
                for line in f:
                    try:
                        rec = json.loads(line)
                    except json.JSONDecodeError:
                        continue
                    if rec.get("step", 0) <= resume_step:
                        kept.append(line)
            with open(self.path, "w") as f:
                f.writelines(kept)
        self._f = open(self.path, "a")
        self._tb = None
        try:
            from torch.utils.tensorboard import SummaryWriter
        except ImportError:   # tensorboard is not installed
            return
        self._tb = SummaryWriter(os.path.join(output_dir, "tb"), purge_step=resume_step)

    def write(self, step: int, **scalars):
        rec = {"step": int(step), "time": time.time()}
        rec.update({k: float(v) for k, v in scalars.items()})
        self._f.write(json.dumps(rec) + "\n")
        self._f.flush()
        if self._tb is not None:
            for k, v in scalars.items():
                self._tb.add_scalar(k, float(v), step)

    def close(self):
        self._f.close()
        if self._tb is not None:
            self._tb.close()


def check_expected_results(results: dict, expected, sigma_tol: float = 4.0):
    """``expected`` is ``[[metric, mean, std], ...]`` (reference
    defaults.py:538-539); raises when a metric deviates from its mean by
    more than ``sigma_tol`` standard deviations or is missing."""
    failures = []
    for item in expected or ():
        metric, mean, std = item[0], float(item[1]), float(item[2])
        actual = results.get(metric)
        if actual is None:
            failures.append(f"metric {metric} missing from results")
            continue
        if abs(actual - mean) > sigma_tol * std:
            failures.append(f"{metric}: {actual:.4f} deviates from {mean:.4f} "
                            f"by more than {sigma_tol}·{std}")
    if failures:
        raise AssertionError("; ".join(failures))
