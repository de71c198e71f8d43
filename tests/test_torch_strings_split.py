"""The port's strings against ``tfhe_tpu.strings`` at PARAM_TEST_TOY on the
CPU: ``split`` and ``rsplit`` of ``tests/test_strings_split.py``; each
iterator runs as many ``next()`` calls as the JAX test's ``drain`` makes.
Each op is bit-equal to the JAX one on the same inputs, decrypts to Rust's
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


def test_split_basic(ctx):
    s, p = enc(ctx, "a,b,c", 5), enc(ctx, ",", 2)
    assert drain(ctx, lambda k, s, p: k.split(s, p), 4, s, p) == [
        "a", "b", "c", None]


def test_rsplit(ctx):
    s = enc(ctx, "a,b", 3)
    assert drain(ctx, lambda k, s: k.rsplit(s, ","), 3, s) == ["b", "a", None]
