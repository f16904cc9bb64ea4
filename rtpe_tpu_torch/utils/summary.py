"""Model summaries over ``named_parameters()`` (port of
``rtpe_tpu/utils/summary.py``; replaces the reference's hook-based
summarizers, ``rtpe/helpers.py:76-180`` and
``rtpe/third_party/utils.py:112-227``).  FLOPs come from one call under
``FlopCounterMode`` (``obs/profiling.py:flops_of``) instead of
per-layer hooks.
"""

from typing import Optional

from torch import nn


def param_count(model: nn.Module) -> int:
    return int(sum(p.numel() for p in model.parameters()))


def model_summary(model: nn.Module, as_string: bool = True,
                  col_sep: int = 46):
    """Per-parameter table and total, like the reference summary."""
    rows = []
    total = 0
    for name, p in sorted(model.named_parameters()):
        total += p.numel()
        rows.append((name, p.numel(), tuple(p.shape)))
    if not as_string:
        return rows, {"TOTAL PARAMS": total}
    fmt = "{:<%d}{:<14}{}" % col_sep
    lines = [fmt.format("Parameter", "Num. params.", "Shape")]
    lines.append("=" * (col_sep + 30))
    for name, n, shape in rows:
        lines.append(fmt.format(name[:col_sep - 1], n, shape))
    lines.append("=" * (col_sep + 30))
    lines.append(f"TOTAL PARAMS: {total}")
    return "\n".join(lines)


def compiled_flops(fn, *args) -> Optional[float]:
    """FLOPs of one call of ``fn(*args)`` (one shared implementation in
    obs/profiling.py)."""
    from ..obs.profiling import flops_of
    return flops_of(fn, *args)
