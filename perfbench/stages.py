"""Stage times of the port's graphed steps, for the per-stage readers.

While ``torch.profiler`` records, a graphed call of the port replays the
capture of its step that carries stage marks and appends the last
replay's device seconds by stage to ``repro_torch.launch.graphs.
stage_log`` (``{"step": ..., "stages": {...}}``): ``serve.decode`` for
the server's decode, ``train`` for the train step.  A port without that
log (older than the marks) gives nothing to read.
"""

from __future__ import annotations

__all__ = ["stage_ms"]


def stage_ms(step: str, stage: str):
    """Device ms of ``stage`` in the newest ``stage_log`` entry of
    ``step``, or None where there is none or it lacks the stage."""
    from repro_torch.launch import graphs
    entries = [e for e in getattr(graphs, "stage_log", ())
               if e["step"] == step]
    if not entries or stage not in entries[-1]["stages"]:
        return None
    return 1e3 * entries[-1]["stages"][stage]
