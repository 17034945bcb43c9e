"""The program's own stage totals, read after a traced window.

The port marks its stages with spans and counters
(``multimodal_decoding_tpu_torch.utils.profiling``), which record only while
a ``torch.profiler`` profile does: in a traced run, the measured window.
``program_summary()`` is that module's ``summary()`` in the run's process,
or None where nothing was recorded or the program has no such record.  A
span's ``stream_s`` is the device stream's time between its entry and its
exit, summed over its instances; a searchlight block is one
``mdt.runner.block`` span.
"""

from __future__ import annotations

BLOCK = "mdt.runner.block"


def program_summary() -> dict | None:
    try:
        from multimodal_decoding_tpu_torch.utils import profiling
    except ImportError:
        return None
    summary = getattr(profiling, "summary", None)
    if summary is None:
        return None
    s = summary()
    return s if s["spans"] or s["counters"] else None


def stream_s(summary: dict, name: str) -> float | None:
    span = summary["spans"].get(name)
    return None if span is None else span["stream_s"]


def per_block_ms(summary: dict, seconds: float | None) -> float | None:
    """``seconds`` of stream time, in milliseconds a searchlight block."""
    blocks = summary["spans"].get(BLOCK)
    if seconds is None or not blocks or not blocks["count"]:
        return None
    return 1e3 * seconds / blocks["count"]
