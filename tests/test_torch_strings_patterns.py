"""The port's strings against ``tfhe_tpu.strings`` at PARAM_TEST_TOY on the
CPU: ``split_ascii_whitespace``, ``eq_ignore_case`` and ``rfind`` of
``tests/test_strings_split.py``. Each op is bit-equal to the JAX one on the
same inputs, decrypts to Rust's (Python's) result and leaves its inputs
unchanged (helpers: ``test_torch_strings.py``; the files are split to keep
each within about a minute and a half on one core).
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


def test_split_ascii_whitespace(ctx):
    s = enc(ctx, " a  bc ", 7)
    assert drain(ctx, lambda k, s: k.split_ascii_whitespace(s), 3, s) == [
        "a", "bc", None]


def test_eq_ignore_case(ctx):
    a = enc(ctx, "AbC", 3)
    assert run(ctx, lambda k, a, b: k.eq_ignore_case(a, b), a,
               enc(ctx, "abc", 3)) is True
    assert run(ctx, lambda k, a, b: k.eq_ignore_case(a, b), a,
               enc(ctx, "abd", 3)) is False


def test_rfind(ctx):
    s = enc(ctx, "abab", 5)
    assert run(ctx, lambda k, s, p: k.rfind(s, p), s,
               enc(ctx, "ab", 3)) == (2, True)
    assert run(ctx, lambda k, s: k.rfind(s, ""), s) == (4, True)
