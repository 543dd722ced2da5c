"""The judgement that decides ``correct``.

The cell's reference module (``reference/<name>.py``, named by the
configuration) computes the comparison's numbers: its plain reference on
the frames the program answered, held against the program's answers.
Each cell file gives each number its limit (``limits``); a run is correct
when every number is at most its limit, every number has a limit and
every limit has a number. ``PERF.md`` gives the readings each limit was
set from.
"""

from __future__ import annotations

import sys


def judge(found: dict[str, float], limits: dict[str, float]) -> tuple[bool, dict]:
    """Whether every number is within its limit, and the numbers beside
    their limits (the result line's ``checks``): every number found and
    every number the limits name. A number with no limit fails, and so
    does a limit with no number: a comparison that drops a number cannot
    pass."""
    names = list(found) + [name for name in limits if name not in found]
    checks = {name: {"value": found.get(name), "limit": limits.get(name)}
              for name in names}
    ok = bool(checks) and all(
        c["value"] is not None and c["limit"] is not None and c["value"] <= c["limit"]
        for c in checks.values())
    return ok, checks


def print_checks(checks: dict) -> None:
    """The numbers compared beside their limits, one line each, on
    standard error."""
    for name, c in checks.items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr, flush=True)
