"""Model-comparison figure builders (seaborn) over the results DataFrame.

Rebuild of the notebook figure layer
(the reference's notebooks/notebook_utils.py:44-177): bar/point metric plots,
faceted cat-plots with per-row metric panels, and the datapoint-count
verification guard that fails loudly when a (model, mode) cell has an
unexpected number of subject datapoints.
"""

from __future__ import annotations

import numpy as np

from multimodal_decoding_tpu_torch.config import MODALITY_AGNOSTIC, SUBJECTS, TRAINING_MODES


def verify_num_datapoints(data, order, x_variable="model", metric=None,
                          expected=None, training_modes=None, strict=True):
    """Per-cell datapoint-count guard (notebook_utils.py:144-157)."""
    expected = expected if expected is not None else len(SUBJECTS)
    training_modes = training_modes or TRAINING_MODES
    metric = metric or data.metric.iloc[0]
    problems = []
    for mode in training_modes:
        data_mode = data[data.training_mode == mode]
        for value in order:
            n = len(data_mode[(data_mode[x_variable] == value) & (data_mode.metric == metric)])
            if n > 0 and n != expected:
                problems.append(
                    f"{mode}: unexpected number of datapoints: {n} "
                    f"(expected {expected}) ({x_variable}: {value})"
                )
    if problems and strict:
        raise RuntimeError("; ".join(problems))
    for p in problems:
        print(f"Warning: {p}")
    return problems


def plot_metric(data, kind="bar", x_variable="model", order=None,
                hue_variable="training_mode", hue_order=None,
                metric="pairwise_acc_captions", ylim=(0.5, 1),
                noise_ceiling=None, ax=None):
    """Single metric bar/point plot (notebook_utils.py:44-82)."""
    import seaborn as sns
    from matplotlib import pyplot as plt

    d = data[data.metric == metric]
    sns.set_style("ticks", {"axes.grid": True})
    if ax is None:
        _, ax = plt.subplots()
    if kind == "bar":
        g = sns.barplot(d, x=x_variable, order=order, y="value",
                        hue=hue_variable, hue_order=hue_order, ax=ax)
    elif kind == "point":
        g = sns.pointplot(d, x=x_variable, order=order, y="value",
                          hue=hue_variable, hue_order=hue_order,
                          errorbar=None, linestyle="none", ax=ax)
    else:
        raise ValueError(f"unknown kind: {kind}")
    if noise_ceiling is not None:
        g.axhline(y=noise_ceiling)
    g.set(ylim=ylim, ylabel=metric, xlabel="")
    plt.tight_layout()
    return g


def create_result_graph(data, x_variable="model", order=None,
                        metrics=("pairwise_acc_captions", "pairwise_acc_images"),
                        hue_variable="training_mode", hue_order=None, ylim=None,
                        plot_modality_specific=True, strict_counts=True,
                        out_path=None):
    """Faceted per-metric comparison grid with count verification
    (notebook_utils.py:135-177)."""
    import seaborn as sns
    from matplotlib import pyplot as plt

    order = list(order) if order is not None else sorted(data[x_variable].unique())
    modes = TRAINING_MODES if plot_modality_specific else [MODALITY_AGNOSTIC]
    verify_num_datapoints(
        data, order, x_variable, metrics[0],
        training_modes=[m for m in modes if m in set(data.training_mode)],
        strict=strict_counts,
    )

    d = data[data.metric.isin(list(metrics))]
    sns.set_style("ticks", {"axes.grid": True})
    g = sns.catplot(
        d, kind="bar", x=x_variable, order=order, y="value", row="metric",
        row_order=list(metrics), hue=hue_variable, hue_order=hue_order,
        height=4, aspect=2.5,
    )
    if ylim is not None:
        g.set(ylim=ylim)
    for m, metric in enumerate(metrics):
        title = metric.replace("pairwise_acc_", "Decoding of ").replace("_", "-")
        g.axes[m, 0].set_title(title)
        g.axes[m, 0].set_ylabel("pairwise accuracy")
    plt.tight_layout()
    if out_path:
        g.figure.savefig(out_path, dpi=150, bbox_inches="tight")
        plt.close(g.figure)
    return g
