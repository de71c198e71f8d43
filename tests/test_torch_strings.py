"""The port's encrypted ASCII strings (``tfhe_tpu_torch.strings``) against
``tfhe_tpu.strings`` at PARAM_TEST_TOY on the CPU (the kernels' plain
versions): the tests of ``tests/test_strings.py``, the string server key's
methods that no JAX test calls, and the coverage of the JAX public names.

Same seed => byte-equal integer keys. Every input is a JAX encryption
carried into the port (``convert.ascii_string_from_arrays``); each op runs
in both packages and the port's output must equal the JAX one bit for bit
(tolerance 0: chars, degrees, noise levels, capacity; boolean blocks and
radix indices too), decrypt to the clear ``str`` result, and leave every
input unchanged.

The helpers here are shared with the other ``test_torch_strings_*.py``
files.
"""

import numpy as np
import pytest
import torch

from tfhe_tpu.integer.radix import BooleanBlock as JBooleanBlock
from tfhe_tpu.integer.radix import RadixCiphertext as JRadixCiphertext
from tfhe_tpu.strings import ascii as jascii
from test_torch_integer_ops import assert_unchanged, integer_keys, snapshot
from test_torch_integer_ops import carry_in as carry_in_integer

from tfhe_tpu_torch import convert
from tfhe_tpu_torch._torus import to_u64
from tfhe_tpu_torch.integer import radix
from tfhe_tpu_torch.strings import ascii

SEED = 41  # tests/test_strings.py's key seed


# ---------------------------------------------------------------------------
# shared helpers
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Run a module's port ops on one torch thread, then restore the count:
    the plain kernels' small int64 ops run many times slower on 8 threads
    than on one (a 16-block TOY mul: 133 s against 8.4 s)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def string_keys(seed):
    """JAX and port string keys from one seed (the port's on the CPU), and
    the integer client keys under them."""
    jick, jisk, ick, isk = integer_keys(seed)
    return {"jck": jascii.StringClientKey(jick),
            "jsk": jascii.StringServerKey(jisk),
            "ck": ascii.StringClientKey(ick),
            "sk": ascii.StringServerKey(isk), "ick": ick}


def carry_in(x):
    """A JAX string, radix ciphertext or boolean block carried into the
    port on the CPU; clear values pass as they are."""
    if isinstance(x, jascii.FheAsciiString):
        c = x.chars
        return convert.ascii_string_from_arrays(
            np.asarray(c.ct), c.degrees, c.noise_levels, c.message_modulus,
            c.carry_modulus, x.capacity, device="cpu")
    if isinstance(x, (JRadixCiphertext, JBooleanBlock)):
        return carry_in_integer(x)
    return x


def _snap(x):
    if isinstance(x, ascii.FheAsciiString):
        return snapshot(x.chars)
    if isinstance(x, (radix.RadixCiphertext, radix.BooleanBlock)):
        return snapshot(x)
    return None


def assert_same(jout, out):
    """The port's output (a string, radix ciphertext, boolean block, or a
    tuple or list of them) equals the JAX one bit for bit."""
    if isinstance(jout, (tuple, list)):
        assert isinstance(out, (tuple, list)) and len(out) == len(jout)
        for j, o in zip(jout, out):
            assert_same(j, o)
        return
    if isinstance(jout, jascii.FheAsciiString):
        assert isinstance(out, ascii.FheAsciiString)
        assert out.capacity == jout.capacity
        jout, out = jout.chars, out.chars
    np.testing.assert_array_equal(to_u64(out.ct), np.asarray(jout.ct))
    if isinstance(jout, JBooleanBlock):
        assert isinstance(out, radix.BooleanBlock)
        return
    assert isinstance(out, radix.RadixCiphertext)
    np.testing.assert_array_equal(out.degrees, np.asarray(jout.degrees))
    np.testing.assert_array_equal(out.noise_levels,
                                  np.asarray(jout.noise_levels))
    assert (out.message_modulus, out.carry_modulus) == (
        jout.message_modulus, jout.carry_modulus)


def clear(ctx, out):
    """What a port output decrypts to: a str, a bool, an int, or a tuple or
    list of them."""
    if isinstance(out, (tuple, list)):
        return type(out)(clear(ctx, o) for o in out)
    if isinstance(out, ascii.FheAsciiString):
        return ctx["ck"].decrypt_ascii(out)
    if isinstance(out, radix.BooleanBlock):
        return bool(np.atleast_1d(
            ctx["sk"].key.decrypt_bool(ctx["ick"], out))[0])
    return int(np.atleast_1d(ctx["ick"].decrypt_radix(out))[0])


def run(ctx, fn, *args):
    """``fn(string_server_key, *args)`` in both packages on the same inputs
    (JAX encryptions, carried into the port, or clear values): the outputs
    equal bit for bit and the inputs stay unchanged. Returns the port
    output's clear value."""
    pargs = [carry_in(a) for a in args]
    snaps = [_snap(a) for a in pargs]
    jout = fn(ctx["jsk"], *args)
    out = fn(ctx["sk"], *pargs)
    assert_same(jout, out)
    for a, s in zip(pargs, snaps):
        if s is not None:
            assert_unchanged(a.chars if isinstance(a, ascii.FheAsciiString)
                             else a, s)
    return clear(ctx, out)


def take(it, n):
    """The first ``n`` (value, is_some) pairs of a split iterator."""
    return [it.next() for _ in range(n)]


def drained(pairs):
    """Clear (value, is_some) pairs as the JAX tests' ``drain`` lists them:
    the values up to the first None, which ends the list."""
    out = []
    for value, some in pairs:
        if not some:
            out.append(None)
            break
        out.append(value)
    return out


def public_names(cls):
    return {n for n in dir(cls) if not n.startswith("_")}


# ---------------------------------------------------------------------------
# this file's keys
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def ctx():
    return string_keys(SEED)


def enc(ctx, text, capacity):
    return ctx["jck"].encrypt_ascii(text, capacity)


# -- tests/test_strings.py ---------------------------------------------------

def test_roundtrip(ctx):
    js = enc(ctx, "Hello", 8)
    s = carry_in(js)
    assert ctx["ck"].decrypt_ascii(s) == "Hello"
    # the port's own encryption, from the same seed and stream position as
    # a fresh JAX key's, equals it
    fresh = string_keys(SEED)
    mine = fresh["ck"].encrypt_ascii("Hello", 8)
    assert_same(fresh["jck"].encrypt_ascii("Hello", 8), mine)
    assert fresh["ck"].decrypt_ascii(mine) == "Hello"


def test_eq_and_case(ctx):
    a, b, c = (enc(ctx, t, 4) for t in ("FhE", "FhE", "fhe"))
    assert run(ctx, lambda k, x, y: k.eq(x, y), a, b) is True
    assert run(ctx, lambda k, x, y: k.eq(x, y), a, c) is False
    assert run(ctx, lambda k, x: k.to_uppercase(x), c) == "FHE"
    assert run(ctx, lambda k, x: k.to_lowercase(x), a) == "fhe"


def test_search(ctx):
    s = enc(ctx, "abcab", 6)
    assert run(ctx, lambda k, x: k.contains_clear(x, "ca"), s) is True
    assert run(ctx, lambda k, x: k.contains_clear(x, "cc"), s) is False
    assert run(ctx, lambda k, x: k.starts_with_clear(x, "ab"), s) is True
    assert run(ctx, lambda k, x: k.ends_with_clear(x, "ab"), s) is True
    assert run(ctx, lambda k, x: k.ends_with_clear(x, "bc"), s) is False
    assert run(ctx, lambda k, x: k.find_clear(x, "ab"), s) == (0, True)
    assert run(ctx, lambda k, x: k.find_clear(x, "ca"), s) == (2, True)


def test_len(ctx):
    assert run(ctx, lambda k, x: k.len(x), enc(ctx, "abc", 6)) == 3
    assert run(ctx, lambda k, x: k.is_empty(x), enc(ctx, "", 4)) is True


# -- the methods no JAX test calls ---------------------------------------------

EXTRA_CASES = {
    "ne": (lambda k, a, b: k.ne(a, b), ("ab", 2), ("ac", 2), True),
    "eq_clear": (lambda k, a, b: (k.eq_clear(a, "ab"), k.eq_clear(a, "b")),
                 ("ab", 3), None, (True, False)),
    "conditional_string": (
        lambda k, a, b: (k.conditional_string(k.is_empty(b), a, b),
                         k.conditional_string(k.ne(a, b), a, b)),
        ("ab", 2), ("c", 3), ("c", "ab")),
    "pat_is_empty": (lambda k, a, b: (k.pat_is_empty(a), k.pat_is_empty(b)),
                     ("", 2), ("a", 1), (True, False)),
    "split_pat_at_index": (
        lambda k, a, b: k.split_pat_at_index(a, b, k.find(a, b)[0], True),
        ("a,b", 3), (",", 1), ("a,", "b")),
    "rsplitn": (lambda k, a, b: take(k.rsplitn(a, b, 2), 3),
                ("a,b", 3), (",", 1), ["b", "a", None]),
    "encrypt_trivial": (lambda k, a, b: k.encrypt_trivial("hi", 3), None, None,
                        "hi"),
}


@pytest.mark.parametrize("name", list(EXTRA_CASES))
def test_method_bit_equal(ctx, name):
    fn, a, b, want = EXTRA_CASES[name]
    args = [enc(ctx, *x) if x is not None else None for x in (a, b)]
    got = run(ctx, fn, *args)
    assert (drained(got) if isinstance(got, list) else got) == want


# names the mirrored tests of the test_torch_strings*.py files call
MIRRORED = {
    "eq", "to_uppercase", "to_lowercase", "contains_clear",
    "starts_with_clear", "ends_with_clear", "find_clear", "len", "is_empty",
    "contains", "starts_with", "ends_with", "find", "lt", "le", "gt", "ge",
    "trim_end", "trim_start", "trim", "concat", "strip_prefix_clear",
    "strip_suffix_clear", "replace_clear", "split", "split_terminator",
    "rsplit", "splitn", "split_inclusive", "rsplit_terminator", "split_once",
    "rsplit_once", "split_ascii_whitespace", "rfind", "eq_ignore_case",
    "repeat", "replace", "replacen", "strip_prefix", "strip_suffix",
}


def test_public_names_match_jax():
    """Every public name of the JAX string keys, string and iterators has a
    counterpart in the port, and every public method of the server key has
    a bit-equality case in one of the test_torch_strings*.py files."""
    for j, p in ((jascii.StringServerKey, ascii.StringServerKey),
                 (jascii.StringClientKey, ascii.StringClientKey),
                 (jascii.FheAsciiString, ascii.FheAsciiString),
                 (jascii.FheStringIterator, ascii.FheStringIterator)):
        assert public_names(j) == public_names(p), j.__name__
    iterators = {n for n, v in vars(jascii).items()
                 if isinstance(v, type)
                 and issubclass(v, jascii.FheStringIterator)}
    assert iterators == {n for n, v in vars(ascii).items()
                         if isinstance(v, type)
                         and issubclass(v, ascii.FheStringIterator)}
    for n in iterators - {"FheStringIterator"}:
        assert public_names(getattr(jascii, n)) == public_names(
            getattr(ascii, n)), n
    assert ascii.CHAR_BLOCKS == jascii.CHAR_BLOCKS
    assert MIRRORED | set(EXTRA_CASES) == public_names(jascii.StringServerKey)


def test_convert_round_trip(ctx):
    js = enc(ctx, "xy", 3)
    arrays = convert.ascii_string_to_arrays(carry_in(js))
    np.testing.assert_array_equal(arrays[0], np.asarray(js.chars.ct))
    np.testing.assert_array_equal(arrays[1], js.chars.degrees)
    np.testing.assert_array_equal(arrays[2], js.chars.noise_levels)
    assert arrays[3:] == (js.chars.message_modulus, js.chars.carry_modulus, 3)
    again = convert.ascii_string_from_arrays(*arrays, device="cpu")
    assert ctx["ck"].decrypt_ascii(again) == "xy"
    with pytest.raises(ValueError, match="capacity"):
        convert.ascii_string_from_arrays(*arrays[:5], 4, device="cpu")


def test_trivial_chars_on_the_key_device(ctx):
    t = ctx["sk"].encrypt_trivial("ok", 2)
    assert t.ct.device == ctx["sk"].key.key.device
    assert t.ct.dtype == torch.int64
