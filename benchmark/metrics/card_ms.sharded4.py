"""Device milliseconds of the slowest card a mesh: of the program's
``sdf.sharded.card`` spans under each mesh's ``sdf.sharded.fields`` span
(one a card, CUDA events from before the card's first launch to after its
last), the largest, summed over the call's meshes, median over the
profiled calls."""

from benchmark.lib import spans


def _slowest(span, group):
    cards = [c.device_ms for c in group
             if c.parent == span.id and c.name == "sdf.sharded.card"]
    if not cards or any(ms is None for ms in cards):
        return None
    return max(cards)


def read(record):
    return spans.median({"sdf.sharded.fields"}, _slowest)
