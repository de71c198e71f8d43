"""The port's encrypted-pattern ``replace`` against ``tfhe_tpu.strings`` at
PARAM_TEST_TOY on the CPU: ``test_replace_encrypted`` of
``tests/test_strings_split.py`` (a file of its own), the output bit-equal to
the JAX one on the same inputs and decrypting to Rust's (Python's) result,
its inputs unchanged (helpers: ``test_torch_strings.py``).
"""

import pytest

from test_torch_strings import (  # noqa: F401  (one_torch_thread: autouse)
    one_torch_thread, run, string_keys)

SEED = 34  # tests/test_strings_split.py's key seed


@pytest.fixture(scope="module")
def ctx():
    return string_keys(SEED)


def test_replace_encrypted(ctx):
    """The JAX test's strings and patterns; the output buffer is cut from
    the default capacity + to.capacity * (capacity + 1) = 14 chars to the
    6 the result needs (``out_capacity``), which keeps the file's run on
    one CPU core within its budget (the rounds' shifts and searches run
    over the output buffer)."""
    enc = ctx["jck"].encrypt_ascii
    s = enc("aXbX", 4)
    assert run(ctx, lambda k, s, frm, to: k.replace(s, frm, to,
                                                    out_capacity=6), s,
               enc("X", 2), enc("YZ", 2)) == "aYZbYZ"
