"""The port's tracing (``tfhe_tpu_torch.utils.trace``) against
``tfhe_tpu.utils.trace`` at PARAM_TEST_TOY on the CPU: for the same op
sequence on byte-equal keys and inputs, the PBS and keyswitch counts and
the nested spans equal ``tfhe_tpu``'s (radix add, mul, eq, scalar_add,
many-LUT, the shortint keyswitch, a cast onto the big key and one onto the
small key); ``profile`` writes a Chrome trace on the CPU, in which every
span is a ``record_function`` range. Tolerance: exact (counts)."""

import json
import os

import numpy as np
import pytest

from tfhe_tpu.integer import radix as jradix
from tfhe_tpu.shortint import compact_public_key as jcpk
from tfhe_tpu.shortint import key_switching_key as jksk
from tfhe_tpu.shortint.ciphertext import ShortintCiphertext as JCiphertext
from tfhe_tpu.shortint.client_key import ClientKey as JClientKey
from tfhe_tpu.shortint.server_key import ServerKey as JServerKey
from tfhe_tpu.utils import csprng as jcsprng
from tfhe_tpu.utils import params as jparams
from tfhe_tpu.utils import trace as jtrace

from test_torch_public_keys import toy_sets
from test_torch_strings import one_torch_thread  # noqa: F401

from tfhe_tpu_torch.integer import radix
from tfhe_tpu_torch.shortint import compact_public_key as cpk
from tfhe_tpu_torch.shortint import key_switching_key as kskm
from tfhe_tpu_torch.shortint.ciphertext import ShortintCiphertext
from tfhe_tpu_torch.shortint.client_key import ClientKey
from tfhe_tpu_torch.shortint.server_key import ServerKey
from tfhe_tpu_torch.utils import csprng
from tfhe_tpu_torch.utils import params as pm
from tfhe_tpu_torch.utils import trace

SEED = 7
BLOCKS = 2
X, Y = 13, 6


def _kit(ck_cls, sk_cls, radix_mod, cpk_mod, ksk_mod, csprng_mod, ct_cls,
         params_mod, **ck_kwargs):
    """One package's keys and inputs: the compute keys at SEED, a second
    keyset at 99, compact keys at 8, the two casting keys."""
    ck = ck_cls.generate(params_mod.PARAM_TEST_TOY, seed=SEED, **ck_kwargs)
    sk = sk_cls.generate(ck)
    ck2 = ck_cls.generate(params_mod.PARAM_TEST_TOY, seed=99, **ck_kwargs)
    sk2 = sk_cls.generate(ck2)
    pke, ks_big = toy_sets(params_mod)
    _, ks_small = toy_sets(params_mod, "SMALL")
    priv = cpk_mod.CompactPrivateKey.generate(pke, seed=8, **ck_kwargs)
    ick, isk = radix_mod.ClientKey(ck), radix_mod.ServerKey(sk)
    many_in = ck.encrypt(np.array([0, 1, 2, 3, 5, 7], dtype=np.uint64))
    return dict(
        ck=ck, sk=sk, isk=isk, ct_cls=ct_cls,
        a=ick.encrypt_radix(np.uint64(X), BLOCKS),
        b=ick.encrypt_radix(np.uint64(Y), BLOCKS),
        many_in=many_in,
        pk=cpk_mod.CompactPublicKey.generate(priv),
        cast_big=ksk_mod.KeySwitchingKey.generate(ck, ck2, sk2, ks_big,
                                                  src_server=sk),
        cast_small=ksk_mod.KeySwitchingKey.generate(priv, ck, sk, ks_small),
        rng=csprng_mod.EncryptionRandomGenerator)


@pytest.fixture(scope="module")
def kits():
    return {
        "jax": _kit(JClientKey, JServerKey, jradix, jcpk, jksk, jcsprng,
                    JCiphertext, jparams),
        "port": _kit(ClientKey, ServerKey, radix, cpk, kskm, csprng,
                     ShortintCiphertext, pm, device="cpu"),
    }


def _many_lut(k):
    sk, ct = k["sk"], k["many_in"]
    ct = k["ct_cls"](ct=ct.ct, degree=7, noise_level=1, message_modulus=4,
                     carry_modulus=4)
    many = sk.generate_many_lookup_table([lambda x: x % 4,
                                          lambda x: (x + 1) % 4])
    return sk.apply_many_lookup_table(ct, many)


def _cast_small(k):
    lst = k["pk"].encrypt(np.array([3, 2, 1], dtype=np.uint64),
                          rng=k["rng"](5, 6))
    return k["cast_small"].cast(lst.expand_to_shortint())


CASES = {
    "add": lambda k: k["isk"].add(k["a"], k["b"]),
    "mul": lambda k: k["isk"].mul(k["a"], k["b"]),
    "eq": lambda k: k["isk"].eq(k["a"], k["b"]),
    "scalar_add": lambda k: k["isk"].scalar_add(k["a"], 9),
    "many_lut": _many_lut,
    "keyswitch": lambda k: k["sk"].keyswitch(k["many_in"]),
    "cast_big": lambda k: k["cast_big"].cast(k["ck"].encrypt([1, 3])),
    "cast_small": _cast_small,
}


def traced(tr, fn, kit):
    """Counts of ``fn`` under an outer span holding an inner one, with a
    PBS-free span beside it, and the module totals."""
    tr.reset_pbs_count()
    with tr.span("outer") as outer:
        with tr.span("inner") as inner:
            fn(kit)
        with tr.span("empty"):
            pass
    return dict(outer=(outer.pbs, outer.ks), inner=(inner.pbs, inner.ks),
                totals=(tr.get_pbs_count(), tr.get_ks_count()),
                children=[(c.name, c.pbs, c.ks) for c in outer.children],
                report_lines=len(outer.report().splitlines()))


@pytest.mark.parametrize("name", list(CASES))
def test_counts_equal_tfhe_tpu(kits, name):
    want = traced(jtrace, CASES[name], kits["jax"])
    got = traced(trace, CASES[name], kits["port"])
    assert got == want
    assert got["report_lines"] == 3
    if name == "keyswitch":
        assert got["totals"] == (0, 6)
    elif name == "cast_small":
        assert got["totals"] == (0, 0)  # keyswitch + pbs_only: uncounted
    else:
        assert got["totals"][0] > 0
    trace.reset_pbs_count()
    assert (trace.get_pbs_count(), trace.get_ks_count()) == (0, 0)


def test_span_seconds_and_report(kits):
    k = kits["port"]
    with trace.span("op") as s:
        k["sk"].apply_lookup_table(k["many_in"],
                                   k["sk"].generate_lookup_table(lambda x: x))
    assert s.seconds > 0 and (s.pbs, s.ks) == (6, 6)
    assert s.report().startswith("op: 6 PBS, 6 KS")


def test_profile_writes_a_trace_with_the_spans(kits, tmp_path):
    """On the CPU: the Chrome trace lands in the log directory, and each
    span is a range of that name on its timeline."""
    k = kits["port"]
    lut = k["sk"].generate_lookup_table(lambda x: x)
    with trace.profile(str(tmp_path)) as prof:
        with trace.span("pbs_round"):
            k["sk"].apply_lookup_table(k["many_in"], lut)
    path = os.path.join(str(tmp_path), trace.TRACE_FILE)
    assert os.path.getsize(path) > 0
    events = json.load(open(path))["traceEvents"]
    assert any(e.get("name") == "pbs_round" for e in events)
    assert any(e.key == "pbs_round" for e in prof.key_averages())
