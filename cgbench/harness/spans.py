"""The port's own host spans (``repro_torch.runtime.tracing``), read after
the traced half of a ``--trace 1`` run: they are recorded only while the
profiler records, and include its cost on every host operation."""
from __future__ import annotations


def per_slot_ms(rec, name: str, self_time: bool = False) -> dict | None:
    """Span ``name``'s wall (or self) time a traced slot in ms, with its
    share of ``cg.run``'s wall time; None without a traced window, where
    the program has no spans, or where ``cg.run``'s calls are not the
    traced slots (a table fed outside the window)."""
    if rec.traced is None or rec.traced.slots == 0:
        return None
    try:
        from repro_torch.runtime import tracing
    except ImportError:
        return None
    table = tracing.totals()
    run, span = table.get("cg.run"), table.get(name)
    if run is None or span is None or run.calls != rec.traced.slots:
        return None
    ns = span.self_ns if self_time else span.wall_ns
    return dict(value=ns / 1e6 / rec.traced.slots,
                share_of_run=ns / run.wall_ns)
