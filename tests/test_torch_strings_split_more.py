"""The port's strings against ``tfhe_tpu.strings`` at PARAM_TEST_TOY on the
CPU: ``split`` with a trailing separator, ``split_terminator``, ``splitn``,
``split_once`` and ``rsplit_once`` of ``tests/test_strings_split.py``. Each
op is bit-equal to the JAX one on the same inputs, decrypts to Rust's
(Python's) result and leaves its inputs unchanged (helpers:
``test_torch_strings.py``; the files are split to keep each within about a
minute and a half on one core).
"""

import pytest

from test_torch_strings import (  # noqa: F401  (one_torch_thread: autouse)
    drained, one_torch_thread, run, string_keys, take)

SEED = 34  # tests/test_strings_split.py's key seed


@pytest.fixture(scope="module")
def ctx():
    return string_keys(SEED)


def enc(ctx, text, capacity):
    return ctx["jck"].encrypt_ascii(text, capacity)


def drain(ctx, make, n, *args):
    """The JAX tests' ``drain``: the first n items of the iterator that
    ``make(key, *args)`` returns, in both packages, listed up to the first
    None."""
    return drained(run(ctx, lambda k, *a: take(make(k, *a), n), *args))


def test_split_trailing_and_terminator(ctx):
    s = enc(ctx, "ab,", 4)
    assert drain(ctx, lambda k, s: k.split(s, ","), 3, s) == ["ab", "", None]
    assert drain(ctx, lambda k, s: k.split_terminator(s, ","), 2, s) == [
        "ab", None]


def test_splitn(ctx):
    s = enc(ctx, "a,b,c", 5)
    assert drain(ctx, lambda k, s: k.splitn(s, ",", 2), 3, s) == [
        "a", "b,c", None]


def test_split_once(ctx):
    s = enc(ctx, "x=y=z", 5)
    assert run(ctx, lambda k, s: k.split_once(s, "="), s) == (
        "x", "y=z", True)
    assert run(ctx, lambda k, s: k.rsplit_once(s, "="), s) == (
        "x=y", "z", True)
