"""What the program's own spans say of a traced window.

The program records a span at each of its layer boundaries while a
profiler session records (``s1s2_torch/utils/profiling.py``: ``spans()``,
host monotonic ns, parents and roots, each span's own syncs), so the
buffer holds the traced window's calls alone: the warm-up calls run with
spans off. A span's self time is its length less its children's; the
self times of all spans sum to their roots' time. Each layer takes the
self time of its spans:

* ``sampler``: ``sampler.call``, ``sampler.step`` and ``q_sample``;
* ``model``: ``model.forward`` (its ``kernel.*`` children left out);
* ``kernel``: every ``kernel.<wrapper>`` (checks, the packed-weight
  lookup, scratch allocation and the launch).

A wait on the card (a sync, or a full launch queue) counts in the span it
happens in. ``syncs`` counts the host–device synchronizations of every
span.
"""

from __future__ import annotations

from typing import Dict, Optional

LAYERS = {"sampler": ("sampler.", "q_sample"), "model": ("model.",), "kernel": ("kernel.",)}


def per_call(ctx) -> Optional[Dict[str, float]]:
    """{layer: host ms a call, "syncs": syncs a call} over the traced
    window's calls; None without device time in the trace, where the
    program records no spans, or where its ``sampler.call`` spans are not
    one a window call."""
    tr, calls = ctx["trace"], ctx["window"].calls
    if tr is None or tr.busy_s <= 0 or not calls:
        return None
    try:
        from s1s2_torch.utils.profiling import spans
    except ImportError:  # a program without spans
        return None
    recs = spans()
    if sum(r.name == "sampler.call" for r in recs) != calls:
        return None
    own = [r.end_ns - r.start_ns for r in recs]
    for r in recs:
        if r.parent >= 0:
            own[r.parent] -= r.end_ns - r.start_ns
    out = dict.fromkeys(LAYERS, 0.0)
    for r, ns in zip(recs, own):
        k = next((k for k, pre in LAYERS.items() if r.name.startswith(pre)), None)
        if k is not None:
            out[k] += ns
    out = {k: v / 1e6 / calls for k, v in out.items()}
    out["syncs"] = sum(r.syncs for r in recs) / calls
    return out
