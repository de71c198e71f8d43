"""The port's strings against ``tfhe_tpu.strings`` at PARAM_TEST_TOY on the
CPU: the encrypted-pattern ``contains``, ``starts_with`` / ``ends_with`` and
``find``, ``strip_prefix_clear`` / ``strip_suffix_clear`` and the equal-
length ``replace_clear`` of ``tests/test_strings_extra.py``. Each op is bit-
equal to the JAX one on the same inputs, decrypts to Rust's (Python's)
result and leaves its inputs unchanged (helpers: ``test_torch_strings.py``;
the files are split to keep each within about a minute and a half on one
core).
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


def test_encrypted_pattern_contains(ctx):
    s = enc(ctx, "hello", 6)
    for pat, cap, want in (("ell", 4, True), ("elo", 4, False), ("", 2, True)):
        assert run(ctx, lambda k, x, p: k.contains(x, p), s,
                   enc(ctx, pat, cap)) is want, pat


def test_encrypted_starts_ends(ctx):
    s = enc(ctx, "abc", 4)
    assert run(ctx, lambda k, x, p: k.starts_with(x, p), s,
               enc(ctx, "ab", 3)) is True
    assert run(ctx, lambda k, x, p: k.starts_with(x, p), s,
               enc(ctx, "b", 2)) is False
    assert run(ctx, lambda k, x, p: k.ends_with(x, p), s,
               enc(ctx, "bc", 3)) is True
    assert run(ctx, lambda k, x, p: k.ends_with(x, p), s,
               enc(ctx, "ab", 3)) is False


def test_encrypted_find(ctx):
    s = enc(ctx, "abab", 5)
    assert run(ctx, lambda k, x, p: k.find(x, p), s,
               enc(ctx, "ba", 3)) == (1, True)
    assert run(ctx, lambda k, x, p: k.find(x, p), s,
               enc(ctx, "zz", 3))[1] is False


def test_strip_prefix_suffix(ctx):
    s = enc(ctx, "abcd", 5)
    assert run(ctx, lambda k, x: k.strip_prefix_clear(x, "ab"), s) == (
        "cd", True)
    assert run(ctx, lambda k, x: k.strip_prefix_clear(x, "xy"), s) == (
        "abcd", False)
    assert run(ctx, lambda k, x: k.strip_suffix_clear(x, "cd"), s) == (
        "ab", True)


def test_replace_equal_length(ctx):
    s = enc(ctx, "abab", 5)
    assert run(ctx, lambda k, x: k.replace_clear(x, "ab", "xy"), s) == "xyxy"
