"""The port's strings against ``tfhe_tpu.strings`` at PARAM_TEST_TOY on the
CPU: the general-length ``replace_clear`` and ``concat`` of
``tests/test_strings_extra.py``. Each op is bit-equal to the JAX one on the
same inputs, decrypts to Rust's (Python's) result and leaves its inputs
unchanged (helpers: ``test_torch_strings.py``; the files are split to keep
each within about a minute and a half on one core).
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


def test_concat(ctx):
    assert run(ctx, lambda k, a, b: k.concat(a, b), enc(ctx, "ab", 4),
               enc(ctx, "cd", 3)) == "abcd"


def test_replace_general_length(ctx):
    s = enc(ctx, "aba", 4)
    assert run(ctx, lambda k, x: k.replace_clear(x, "b", "bb"), s) == "abba"
    assert run(ctx, lambda k, x: k.replace_clear(x, "ab", "z"), s) == "za"
