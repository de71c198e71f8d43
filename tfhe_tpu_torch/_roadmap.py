"""The ROADMAP items that the port's ``NotImplementedError`` messages name.

A piece of ``tfhe_tpu`` that the port does not carry yet raises instead of
running another path; its message names the Queue A item of ``ROADMAP.md``
that ports it, by number and by the title that item has there.
"""

from __future__ import annotations

ITEMS = {
    9: "platform layers",
}


def not_ported(what: str, *items: int) -> NotImplementedError:
    """The error for ``what``, which waits on the Queue A ``items``."""
    named = "; ".join(f"item {i}: {ITEMS[i]}" for i in items)
    return NotImplementedError(
        f"{what} is not ported yet (ROADMAP Queue A {named})")

