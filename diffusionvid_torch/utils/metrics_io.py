"""The ``TEST.EXPECTED_RESULTS`` regression check (port of
``diffusionvid_tpu/utils/metrics_io.py:58``)."""

from __future__ import annotations


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
