"""The port's exact CRT path and the plain versions of its new kernels
against tfhe_tpu, on the same numpy inputs:

- bootstrap_key_to_ntt, the scan layouts, external product, blind rotation
  and the portable PBS against ``tfhe_tpu.ops.server``;
- the plain K2 (u64 mode) -> plain K3 (Garner tail) pipeline against
  ``blind_rotate_pallas`` in interpret mode for TFHE_NTT_VARIANT v4 (the
  two-plane v4 kernel, P = 3) and v1 (the legacy kernel), as
  tests/test_pbs_kernel.py runs it;
- the plain K2 u64 against ``_build_body_rot_fn_v4(acc32=False)``;
- the plain K3 (BNF2 tail) against ``blind_rotate_pallas(bnf2=True)`` under
  TFHE_V4_ACC=64;
- the shortint ``crt`` variant and ``TFHE_V4_ACC=64`` at PARAM_TEST_TOY.

Tolerance: exact (integer arithmetic)."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from tfhe_tpu.core import algorithms as jalgo
from tfhe_tpu.core.entities import LweBootstrapKey as JLweBootstrapKey
from tfhe_tpu.ops import bnf2 as jb2
from tfhe_tpu.ops import ntt as jntt
from tfhe_tpu.ops import pbs_kernel as jpk
from tfhe_tpu.ops import server as jserver
from tfhe_tpu.shortint import server_key as jserver_key
from tfhe_tpu.shortint.client_key import ClientKey as JClientKey
from tfhe_tpu.shortint.server_key import ServerKey as JServerKey
from tfhe_tpu.utils.params import PARAM_TEST_TOY as JP

from tfhe_tpu_torch._torus import from_u32, from_u64, to_u32, to_u64
from tfhe_tpu_torch.core import algorithms as algo
from tfhe_tpu_torch.core.entities import LweBootstrapKey
from tfhe_tpu_torch.ops import bnf2 as b2
from tfhe_tpu_torch.ops import ntt
from tfhe_tpu_torch.ops import pbs_kernel as pk
from tfhe_tpu_torch.ops import server
from tfhe_tpu_torch.shortint.ciphertext import ShortintCiphertext
from tfhe_tpu_torch.shortint.client_key import ClientKey
from tfhe_tpu_torch.shortint.server_key import ServerKey, num_primes_for
from tfhe_tpu_torch.utils.params import PARAM_TEST_TOY as P

# the boolean shape at toy width: N=256, k=2, base_log 10 x 2 levels, P=3
N, R, BL, L, NP = 256, 3, 10, 2, 3


def _ntt_key(rng, n_steps, num_primes=NP, levels=L, R=R, N=N):
    """A random standard-domain BSK and its JAX CRT key (legacy layout)."""
    std = rng.integers(0, 1 << 64, size=(n_steps, levels, R, R, N),
                       dtype=np.uint64)
    hat = np.asarray(jalgo.bootstrap_key_to_ntt(
        JLweBootstrapKey(std, BL, levels), num_primes).residues)
    return std, hat


def _rotation_inputs(rng, B, n_steps, R=R, N=N):
    lut = rng.integers(0, 1 << 64, size=(B, R, N), dtype=np.uint64)
    mask = rng.integers(0, 2 * N, size=(B, n_steps), dtype=np.uint64)
    body = rng.integers(0, 2 * N, size=(B,), dtype=np.uint64)
    return lut, mask, body


def test_bootstrap_key_to_ntt_and_layouts_match_jax():
    rng = np.random.default_rng(1)
    std, want = _ntt_key(rng, 3)
    got = algo.bootstrap_key_to_ntt(
        LweBootstrapKey(from_u64(std, "cpu"), BL, L), NP)
    assert got.num_primes == NP and got.residues.is_contiguous()
    np.testing.assert_array_equal(to_u32(got.residues), want)
    scan = pk.bsk_to_scan_layout(got.residues)
    np.testing.assert_array_equal(
        to_u32(scan), np.asarray(jpk.bsk_to_scan_layout(jnp.asarray(want))))
    np.testing.assert_array_equal(
        to_u32(pk.scan_to_legacy_layout(scan, L)), want)


@pytest.mark.parametrize("batch", [(), (4,)])
def test_external_product_matches_jax(batch):
    rng = np.random.default_rng(2 + len(batch))
    _, hat = _ntt_key(rng, 1)
    glwe = rng.integers(0, 1 << 64, size=batch + (R, N), dtype=np.uint64)
    plan, jplan = ntt.get_plan(N, NP), jntt.get_plan(N, NP)
    got = server.external_product_ntt(from_u32(hat[:, :, 0], "cpu"),
                                      from_u64(glwe, "cpu"), BL, L, plan)
    want = np.asarray(jax.jit(jserver.external_product_ntt,
                              static_argnums=(2, 3, 4))(
        jnp.asarray(hat[:, :, 0]), jnp.asarray(glwe), BL, L, jplan))
    np.testing.assert_array_equal(to_u64(got), want)


def test_blind_rotate_and_pbs_match_jax():
    rng = np.random.default_rng(4)
    n_steps, B = 5, 3
    _, hat = _ntt_key(rng, n_steps)
    lut, mask, body = _rotation_inputs(rng, B, n_steps)
    plan, jplan = ntt.get_plan(N, NP), jntt.get_plan(N, NP)
    want = np.asarray(jserver.blind_rotate(
        jnp.asarray(lut), jnp.asarray(mask), jnp.asarray(body),
        jnp.asarray(hat), BL, L, jplan))
    got = server.blind_rotate(from_u64(lut, "cpu"), from_u64(mask, "cpu"),
                              from_u64(body, "cpu"), from_u32(hat, "cpu"),
                              BL, L, plan)
    np.testing.assert_array_equal(to_u64(got), want)
    # acc32 mode: the accumulator and each increment rounded to 2^32
    want32 = np.asarray(jserver.blind_rotate(
        jnp.asarray(lut), jnp.asarray(mask), jnp.asarray(body),
        jnp.asarray(hat), BL, L, jplan, acc_round32=True))
    got32 = server.blind_rotate(from_u64(lut, "cpu"), from_u64(mask, "cpu"),
                                from_u64(body, "cpu"), from_u32(hat, "cpu"),
                                BL, L, plan, acc_round32=True)
    np.testing.assert_array_equal(to_u64(got32), want32)
    # the portable PBS, and the kernel path through the plain versions
    ct = rng.integers(0, 1 << 64, size=(B, n_steps + 1), dtype=np.uint64)
    want = np.asarray(jserver.programmable_bootstrap(
        jnp.asarray(ct), jnp.asarray(lut[0]), jnp.asarray(hat), BL, L, jplan,
        centered_ms=False))
    got = server.programmable_bootstrap(
        from_u64(ct, "cpu"), from_u64(lut[0], "cpu"), from_u32(hat, "cpu"),
        BL, L, plan, centered_ms=False)
    np.testing.assert_array_equal(to_u64(got), want)
    scan = pk.bsk_to_scan_layout(from_u32(hat, "cpu"))
    pk.reset_launches()
    got = server.programmable_bootstrap_crt(
        from_u64(ct, "cpu"), from_u64(lut[0], "cpu"), scan, BL, L,
        centered_ms=False)
    np.testing.assert_array_equal(to_u64(got), want)
    assert pk.body_rotate_u64.launches == 0
    assert pk.blind_rotate_crt.launches == 0


@pytest.mark.parametrize("variant", ["v4", "v1"])
def test_plain_k3_matches_pallas_interpret(variant, monkeypatch):
    """plain K2 (u64) then plain K3 (Garner tail) == blind_rotate_pallas on
    the exact CRT key, one real pallas_call per step in interpret mode."""
    monkeypatch.setenv("TFHE_NTT_VARIANT", variant)
    monkeypatch.delenv("TFHE_V4_ACC", raising=False)
    rng = np.random.default_rng(7)
    # one level and k = 1 keep the interpreted kernel small; still P = 3
    # (10 + 64 + 8 + 1 bits); the multi-level digits are held against the
    # JAX spec in test_blind_rotate_and_pbs_match_jax
    n_steps, B, R1, L1 = 2, 4, 2, 1
    _, hat = _ntt_key(rng, n_steps, levels=L1, R=R1)
    lut, mask, body = _rotation_inputs(rng, B, n_steps, R=R1)
    scan = np.asarray(jpk.bsk_to_scan_layout(jnp.asarray(hat)))
    want = np.asarray(jpk.blind_rotate_pallas(
        jnp.asarray(lut), jnp.asarray(mask), jnp.asarray(body),
        jnp.asarray(scan), BL, L1, jntt.get_plan(N, NP), unroll=1))
    acc = pk.body_rotate_u64(from_u64(lut, "cpu"), from_u64(body, "cpu"))
    got = pk.blind_rotate_crt(acc, from_u64(mask, "cpu"),
                              from_u32(scan, "cpu"), BL, L1)
    np.testing.assert_array_equal(to_u64(got), want)


@pytest.mark.parametrize("R_", [2, 5])
def test_plain_body_rotation_u64_matches_pallas_interpret(R_):
    """plain K2 u64 == _build_body_rot_fn_v4(acc32=False) in interpret
    mode, on the transposed [R, G, B, 128] layout of the Pallas kernel."""
    n, B = 256, 4
    G = n // 128
    rng = np.random.default_rng(R_)
    lut = rng.integers(0, 1 << 64, size=(B, R_, n), dtype=np.uint64)
    body = rng.integers(0, 2 * n, size=(B,), dtype=np.uint64)
    body[:2] = [0, n]
    acc = jpk.to_transposed_layout(jnp.moveaxis(jnp.asarray(lut), 1, 0), G)
    hi, lo = jpk.split_u64(jnp.moveaxis(acc, 2, 1))  # [R, G, B, 128]
    a_rot = ((2 * n - jnp.asarray(body)) % (2 * n)).astype(jnp.uint32)
    out_hi, out_lo = jpk._build_body_rot_fn_v4(n, R_, 2, acc32=False)(
        a_rot[None, :, None], hi, lo)
    want = np.asarray(jnp.moveaxis(jpk.from_transposed_layout(
        jnp.moveaxis(jpk.merge_u64(out_hi, out_lo), 1, 2)), 0, 1))
    got = pk.body_rotate_u64(from_u64(lut, "cpu"), from_u64(body, "cpu"))
    np.testing.assert_array_equal(to_u64(got), want)
    shared = pk.body_rotate_u64(from_u64(lut[0], "cpu"),
                                from_u64(body, "cpu"))
    np.testing.assert_array_equal(
        to_u64(shared), to_u64(pk.body_rotate_u64_plain(
            from_u64(np.broadcast_to(lut[0], lut.shape), "cpu"),
            from_u64(body, "cpu"))))


@pytest.mark.parametrize("name", ["DEFAULT", "FAST28"])
def test_plain_k3_bnf2_matches_pallas_interpret(name, monkeypatch):
    """plain K2 (u64) then plain K3 (BNF2 tail) == the v6 Pallas kernels in
    two-plane mode (TFHE_V4_ACC=64), bit for bit."""
    monkeypatch.setenv("TFHE_V4_ACC", "64")
    fl, jfl = {"DEFAULT": (b2.DEFAULT, jb2.DEFAULT),
               "FAST28": (b2.FAST28, jb2.FAST28)}[name]
    rng = np.random.default_rng(21)
    n_steps, B, R2 = 3, 4, 2
    lut, mask, body = _rotation_inputs(rng, B, n_steps, R=R2)
    std = rng.integers(0, 1 << 64, size=(n_steps, 1, R2, R2, N),
                       dtype=np.uint64)
    bsk2 = np.asarray(jb2.bootstrap_key_to_bnf2(std, flavor=jfl))
    want = np.asarray(jpk.blind_rotate_pallas(
        jnp.asarray(lut), jnp.asarray(mask), jnp.asarray(body),
        jnp.asarray(bsk2), 23, 1, jfl.plan(N), batch_tile=2, unroll=1,
        bnf2=True, bnf2_flavor=jfl))
    acc = pk.body_rotate_u64(from_u64(lut, "cpu"), from_u64(body, "cpu"))
    got = pk.blind_rotate_bnf2_u64(acc, from_u64(mask, "cpu"),
                                   from_u32(bsk2, "cpu"), 23, 1, fl)
    np.testing.assert_array_equal(to_u64(got), want)


def test_kernel_constants_layout():
    """K3's tables and Garner constants hold the plan's values at the
    offsets the CUDA source reads."""
    plan = ntt.get_plan(N, 4)
    t = pk.plan_tables(plan)
    assert t.shape == (4, 8, N) and t.dtype == np.uint32
    np.testing.assert_array_equal(t[3, 2], plan.untwist[3])
    c = [int(x) for x in pk.garner_constants(plan)]
    assert len(c) == 5 + 5 + 5 + 25 + 25
    ps = plan.primes
    assert c[:4] == list(ps) and c[4] == 0
    for i in range(1, 4):
        prod = int(np.prod([ps[j] for j in range(i)], dtype=object))
        assert (c[5 + i] * prod) % ps[i] == 1
        assert c[10 + i] == (c[5 + i] << 32) // ps[i]
        for j in range(i):
            assert c[15 + 5 * i + j] == ps[j] % ps[i]
            assert c[40 + 5 * i + j] == (c[15 + 5 * i + j] << 32) // ps[i]


# ---------------------------------------------------------------------------
# shortint at PARAM_TEST_TOY: the crt variant and the two-plane v6b path
# ---------------------------------------------------------------------------

SEED = 424242


def _shortint_case(monkeypatch, env):
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    # tfhe_tpu caches its jitted KS -> PBS by key shape and variant, not by
    # TFHE_V4_ACC: a fresh cache for the test keeps what it jits under
    # ``env`` from answering a later test of the same worker
    monkeypatch.setattr(jserver_key, "_jitted_ks_pbs_cache", {})
    jck = JClientKey.generate(JP, seed=SEED)
    jsk = JServerKey.generate(jck)
    ck = ClientKey.generate(P, seed=SEED, device="cpu")
    sk = ServerKey.generate(ck)
    mod = P.message_modulus * P.carry_modulus
    f = lambda x: (5 * x + 3) % mod
    vals = np.arange(mod, dtype=np.uint64)
    jct = jck.encrypt(vals)
    jout = jsk.apply_lookup_table(jct, jsk.generate_lookup_table(f))
    ct = ShortintCiphertext(ct=from_u64(np.asarray(jct.ct), "cpu"),
                            degree=jct.degree, noise_level=jct.noise_level,
                            message_modulus=jct.message_modulus,
                            carry_modulus=jct.carry_modulus)
    out = sk.apply_lookup_table(ct, sk.generate_lookup_table(f))
    np.testing.assert_array_equal(to_u64(out.ct), np.asarray(jout.ct))
    np.testing.assert_array_equal(
        ck.decrypt_message_and_carry(out),
        np.array([f(int(v)) for v in vals], dtype=np.uint64))
    return jsk, sk


def test_shortint_crt_variant_bit_equal(monkeypatch):
    jsk, sk = _shortint_case(monkeypatch, {"TFHE_NTT_VARIANT": "crt"})
    assert sk.ntt_variant == jsk.ntt_variant == "crt"
    assert sk.num_primes == jsk.num_primes == num_primes_for(P) == 4
    np.testing.assert_array_equal(to_u32(sk.bsk_scan),
                                  np.asarray(jsk.bsk_scan))


def test_shortint_two_plane_v6b_bit_equal(monkeypatch):
    jsk, sk = _shortint_case(monkeypatch, {"TFHE_V4_ACC": "64"})
    assert sk.ntt_variant == jsk.ntt_variant == "v6b"


def test_crt_acc32_rounds_like_the_tpu_kernel(monkeypatch):
    """TFHE_V4_ACC=32 asks the exact CRT path for the rounded accumulator of
    the TPU kernel: programmable_bootstrap_crt then equals the acc_round32
    oracle of tfhe_tpu (switch -> blind_rotate(acc_round32=True) ->
    extract); under TFHE_NTT_VARIANT=crt the path stays exact."""
    rng = np.random.default_rng(11)
    n_steps, B = 3, 2
    _, hat = _ntt_key(rng, n_steps)
    lut = rng.integers(0, 1 << 64, size=(R, N), dtype=np.uint64)
    ct = rng.integers(0, 1 << 64, size=(B, n_steps + 1), dtype=np.uint64)
    jplan = jntt.get_plan(N, NP)
    ms_mask, ms_body = jserver.lwe_standard_modulus_switch(
        jnp.asarray(ct), N.bit_length())
    run = lambda: to_u64(server.programmable_bootstrap_crt(
        from_u64(ct, "cpu"), from_u64(lut, "cpu"),
        pk.bsk_to_scan_layout(from_u32(hat, "cpu")), BL, L,
        centered_ms=False))
    monkeypatch.setenv("TFHE_V4_ACC", "32")
    monkeypatch.delenv("TFHE_NTT_VARIANT", raising=False)
    for exact in (False, True):
        want = np.asarray(jserver.sample_extract(jserver.blind_rotate(
            jnp.broadcast_to(jnp.asarray(lut), (B, R, N)), ms_mask, ms_body,
            jnp.asarray(hat), BL, L, jplan, acc_round32=not exact)))
        np.testing.assert_array_equal(run(), want)
        assert ((want & np.uint64(0xFFFFFFFF)) == 0).all() != exact
        monkeypatch.setenv("TFHE_NTT_VARIANT", "crt")
