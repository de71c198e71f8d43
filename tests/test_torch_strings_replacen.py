"""The port's strings against ``tfhe_tpu.strings`` at PARAM_TEST_TOY on the
CPU: ``repeat``, ``replacen``, the empty-pattern ``replace`` and the
encrypted ``strip_prefix`` / ``strip_suffix`` of
``tests/test_strings_split.py``. Each op is bit-equal to the JAX one on the
same inputs, decrypts to Rust's (Python's) result and leaves its inputs
unchanged (helpers: ``test_torch_strings.py``; the files are split to keep
each within about a minute and a half on one core).
"""

import numpy as np
import pytest

from test_torch_strings import (  # noqa: F401  (one_torch_thread: autouse)
    one_torch_thread, run, string_keys)

SEED = 34  # tests/test_strings_split.py's key seed


@pytest.fixture(scope="module")
def ctx():
    return string_keys(SEED)


def enc(ctx, text, capacity):
    return ctx["jck"].encrypt_ascii(text, capacity)


def test_repeat(ctx):
    s = enc(ctx, "ab", 2)
    assert run(ctx, lambda k, s: k.repeat(s, 3), s) == "ababab"
    n = ctx["jck"].inner.encrypt_radix(np.uint64(2), 4)
    assert run(ctx, lambda k, s, n: k.repeat(s, n, max_n=3), s, n) == "abab"


def test_replacen(ctx):
    s = enc(ctx, "aXbX", 4)
    assert run(ctx, lambda k, s, to: k.replacen(s, "X", to, 1), s,
               enc(ctx, "Y", 1)) == "aYbX"


def test_replace_empty_pattern(ctx):
    s = enc(ctx, "ww", 2)
    assert run(ctx, lambda k, s, to: k.replace(s, "", to), s,
               enc(ctx, "a", 1)) == "awawa"


def test_strip_encrypted(ctx):
    s = enc(ctx, "abcd", 4)
    assert run(ctx, lambda k, s, p: k.strip_prefix(s, p), s,
               enc(ctx, "ab", 2)) == ("cd", True)
    assert run(ctx, lambda k, s, p: k.strip_suffix(s, p), s,
               enc(ctx, "cd", 3)) == ("ab", True)
    assert run(ctx, lambda k, s, p: k.strip_suffix(s, p), s,
               enc(ctx, "xx", 2)) == ("abcd", False)
