"""The port's strings against ``tfhe_tpu.strings`` at PARAM_TEST_TOY on the
CPU: ``trim_end`` / ``trim_start`` / ``trim`` and the lexicographic
comparisons of ``tests/test_strings_extra.py``. Each op is bit-equal to the
JAX one on the same inputs, decrypts to Rust's (Python's) result and leaves
its inputs unchanged (helpers: ``test_torch_strings.py``; the files are
split to keep each within about a minute and a half on one core).
"""

import pytest

from test_torch_strings import (  # noqa: F401  (one_torch_thread: autouse)
    one_torch_thread, run, string_keys)

SEED = 33  # tests/test_strings_extra.py's key seed


@pytest.fixture(scope="module")
def ctx():
    return string_keys(SEED)


def enc(ctx, text, capacity):
    return ctx["jck"].encrypt_ascii(text, capacity)


def test_lexicographic_cmp(ctx):
    pairs = [("abc", "abd"), ("abc", "abc"), ("b", "abc"), ("abc", "ab")]
    for x, y in pairs:
        a, c = enc(ctx, x, 4), enc(ctx, y, 4)
        got = run(ctx, lambda k, a, c: (k.lt(a, c), k.le(a, c), k.gt(a, c),
                                        k.ge(a, c)), a, c)
        assert got == (x < y, x <= y, x > y, x >= y), (x, y)


def test_trim(ctx):
    s = enc(ctx, "  hi ", 6)
    assert run(ctx, lambda k, x: k.trim_end(x), s) == "  hi"
    assert run(ctx, lambda k, x: k.trim_start(x), s) == "hi "
    assert run(ctx, lambda k, x: k.trim(x), s) == "hi"
