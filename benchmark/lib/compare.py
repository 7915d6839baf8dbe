"""The comparison that decides ``correct``: each number beside its limit.

A cell's ``limits/<workload>.json`` maps each number the entry's check
returns to ``{"limit": x, ...}`` (the readings it was set from beside it).
A number passes when it is at most its limit; a number that is missing or
not finite fails. Numbers the check gives and the limits do not name are
readings, printed beside and not compared.
"""

from __future__ import annotations

import math


def judge(numbers: dict, limits: dict):
    """(correct, {name: {"value": v, "limit": l, "ok": passed}}) over every
    number the limits name; a number the check did not give fails."""
    rows, ok = {}, True
    for name in limits:
        value = numbers.get(name)
        limit = limits.get(name, {}).get("limit")
        good = (value is not None and limit is not None
                and math.isfinite(value) and value <= limit)
        ok = ok and good
        rows[name] = {"value": value, "limit": limit, "ok": good}
    return ok and bool(rows), rows


def lines(rows: dict):
    """One line a number: name, value, limit, and the verdict."""
    return [f"check {name} = {r['value']!r} (limit {r['limit']!r}) "
            f"{'ok' if r['ok'] else 'FAILED'}" for name, r in rows.items()]
