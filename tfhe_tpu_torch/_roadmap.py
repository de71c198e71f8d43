"""The ROADMAP items that the port's ``NotImplementedError`` messages name.

A piece of ``tfhe_tpu`` that the port does not carry yet raises instead of
running another path; its message names the Queue A item of ``ROADMAP.md``
that ports it, by number and by the title that item has there.
"""

from __future__ import annotations

ITEMS = {
    7: "u128 noise squashing",
    8: "other PBS flavors",
    9: "platform layers",
}


def not_ported(what: str, *items: int) -> NotImplementedError:
    """The error for ``what``, which waits on the Queue A ``items``."""
    named = "; ".join(f"item {i}: {ITEMS[i]}" for i in items)
    return NotImplementedError(
        f"{what} is not ported yet (ROADMAP Queue A {named})")


def unported_class(name: str, what: str, items: tuple, constructors=()):
    """A class of ``tfhe_tpu`` whose module the port does not carry yet:
    making one, or calling one of its ``constructors``, raises."""

    def refuse(*args, **kwargs):
        raise not_ported(what, *items)

    ns = {"__doc__": f"Not ported yet: {what}.",
          "__init__": lambda self, *a, **k: refuse()}
    ns.update({c: classmethod(lambda cls, *a, **k: refuse())
               for c in constructors})
    return type(name, (), ns)
