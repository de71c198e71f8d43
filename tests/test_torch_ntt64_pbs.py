"""The port's prime-modulus NTT64 PBS (``tfhe_tpu_torch/ops/ntt64_pbs.py``,
its kernel K6's plain version ``cmux_steps_q``) against
``tfhe_tpu.ops.ntt64_pbs`` at a toy size (n = 8, k = 2, N = 256, b = 10,
l = 2, B = 4; keys from numpy seed 0): the non-native decomposer, the
closest representable value, the modulus switch, the key, the mod-q
encryptions, the blind rotation (a mask of 2N and of 0 included), the
sample extraction, the LUT and the whole PBS, all bit-equal (tolerance 0).
Each JAX function runs once, in the module fixture; the port on one torch
thread."""

import numpy as np
import pytest
import torch

import tfhe_tpu  # noqa: F401  (enables x64)
from tfhe_tpu.ops import ntt64_pbs as jn
from tfhe_tpu_torch._torus import from_u64, to_u64
from tfhe_tpu_torch.ops import ntt64_pbs as pn
from tfhe_tpu_torch.ops import pbs_kernel as pk

Q = pn.Q
n, k, N, BASE_LOG, LEVELS, B = 8, 2, 256, 10, 2, 4
MM = 16
DELTA = (1 << 63) // MM
GLWE_STD, LWE_STD = 1e3, 1e6
EDGES = [0, 1, Q // 2, Q // 2 + 1, Q - 1, 1 << 63, Q - (1 << 40),
         (Q + 1) // 2, (Q - 1) // 2]


@pytest.fixture(autouse=True)
def one_torch_thread():
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


def _keys(rng):
    return (rng.integers(0, 2, size=n).astype(np.uint8),
            rng.integers(0, 2, size=(k, N)).astype(np.uint8))


def _rotation_inputs():
    rng = np.random.default_rng(5)
    mask = rng.integers(0, 2 * N + 1, size=(B, n)).astype(np.uint64)
    mask[0, :3] = [2 * N, 0, 2 * N]
    mask[1] = 0
    body = np.array([2 * N, 0, 17, 2 * N - 1], dtype=np.uint64)
    return mask, body


@pytest.fixture(scope="module")
def jax_run():
    """tfhe_tpu's keygen, encryption, rotation and PBS, each once."""
    rng = np.random.default_rng(0)
    lwe_sk, glwe_sk = _keys(rng)
    bsk_q = jn.gen_bootstrap_key_ntt64(lwe_sk, glwe_sk, BASE_LOG, LEVELS,
                                       GLWE_STD, rng)
    bsk_hat = jn.bootstrap_key_to_ntt64(bsk_q)
    pts = (np.arange(B, dtype=np.uint64) * np.uint64(5 * DELTA)) % \
        np.uint64(Q)
    cts = jn.lwe_encrypt_q(lwe_sk, pts, LWE_STD, rng)
    lut = jn.generate_lut_q(N, k + 1, MM, DELTA, lambda x: 2 * x)
    out = jn.pbs_ntt64(cts, lut, bsk_hat, BASE_LOG, LEVELS)
    mask, body = _rotation_inputs()
    import jax.numpy as jnp

    rot = jn.blind_rotate_ntt64(
        jnp.broadcast_to(jnp.asarray(lut)[None], (B, k + 1, N)),
        jnp.asarray(mask), jnp.asarray(body), bsk_hat, BASE_LOG, LEVELS)
    rot = np.asarray(rot, dtype=np.uint64)
    return dict(lwe_sk=lwe_sk, glwe_sk=glwe_sk, bsk_q=np.asarray(bsk_q),
                bsk_hat=np.asarray(bsk_hat, dtype=np.uint64), pts=pts,
                cts=cts, lut=lut, out=out, rot=rot,
                extract=np.asarray(jn.sample_extract_q(jnp.asarray(rot)),
                                   dtype=np.uint64),
                extract5=np.asarray(jn.sample_extract_q(jnp.asarray(rot), 5),
                                    dtype=np.uint64))


@pytest.fixture(scope="module")
def port_run():
    """The port's keygen, encryption and PBS on the CPU from the same
    seed."""
    rng = np.random.default_rng(0)
    lwe_sk, glwe_sk = _keys(rng)
    bsk_q = pn.gen_bootstrap_key_ntt64(lwe_sk, glwe_sk, BASE_LOG, LEVELS,
                                       GLWE_STD, rng, device="cpu")
    bsk_hat = pn.bootstrap_key_to_ntt64(bsk_q)
    pts = (np.arange(B, dtype=np.uint64) * np.uint64(5 * DELTA)) % \
        np.uint64(Q)
    cts = pn.lwe_encrypt_q(lwe_sk, pts, LWE_STD, rng, device="cpu")
    lut = pn.generate_lut_q(N, k + 1, MM, DELTA, lambda x: 2 * x)
    pk.reset_launches()
    out = pn.pbs_ntt64(cts, lut, bsk_hat, BASE_LOG, LEVELS)
    return dict(bsk_q=bsk_q, bsk_hat=bsk_hat, cts=cts, lut=lut, out=out,
                glwe_sk=glwe_sk)


def _random_values(seed=7, count=1 << 12, q=Q):
    rng = np.random.default_rng(seed)
    vals = rng.integers(0, q, size=count, dtype=np.uint64)
    edges = np.array([e % q for e in EDGES], dtype=np.uint64)
    return np.concatenate([vals, edges])


# -- the non-native decomposer -------------------------------------------------

@pytest.mark.parametrize("q", [(1 << 48) - 1, (1 << 48) + 1])
def test_init_state_doc_vectors(q):
    """decomposer.rs:470-490: b = 4, l = 3, 249280154129830 -> closest_abs
    32160715112448 at q = 2^48 -+ 1, in both packages."""
    v = np.array([249280154129830], dtype=np.uint64)
    state, neg = pn.init_state_nonnative(v, 4, 3, q)
    jstate, jneg = jn.init_state_nonnative(v, 4, 3, q)
    assert int(state[0]) << (q.bit_length() - 12) == 32160715112448
    assert int(state[0]) == int(np.asarray(jstate)[0])
    assert bool(neg[0]) == bool(np.asarray(jneg)[0])


DECOMP_CASES = [(q, b, lev) for q in (Q, (1 << 48) - 1, (1 << 48) + 1)
                for b, lev in ((4, 3), (6, 4), (BASE_LOG, LEVELS), (23, 1),
                               (21, 3), (1, 47))
                if b * lev < q.bit_length()]


@pytest.mark.parametrize("q,b,lev", DECOMP_CASES)
def test_decompose_equals_tfhe_tpu(q, b, lev):
    """2^12 random values and the edge values: digits, states and signs
    bit-equal, digits balanced, recomposition == closest representable."""
    vals = _random_values(q=q)
    got = pn.decompose_nonnative(vals, b, lev, q)
    want = np.asarray(jn.decompose_nonnative(vals, b, lev, q)).astype(
        np.int64)
    np.testing.assert_array_equal(got.numpy(), want)
    assert int(got.abs().max()) <= 1 << (b - 1)
    state, neg = pn.init_state_nonnative(vals, b, lev, q)
    jstate, jneg = jn.init_state_nonnative(vals, b, lev, q)
    np.testing.assert_array_equal(state.numpy(),
                                  np.asarray(jstate).astype(np.int64))
    np.testing.assert_array_equal(neg.numpy(), np.asarray(jneg))
    closest = pn.closest_representable_nonnative(vals, b, lev, q)
    jclosest = np.asarray(jn.closest_representable_nonnative(vals, b, lev, q))
    np.testing.assert_array_equal(to_u64(closest), jclosest)
    q_bits = q.bit_length()
    rec = sum(got[:, i].numpy().astype(object) << (q_bits - b * (lev - i))
              for i in range(lev))
    np.testing.assert_array_equal(
        np.array([int(x) % q for x in rec], dtype=np.uint64), jclosest)


def test_recomposition_summand_equals_tfhe_tpu():
    v = np.array([-1, 0, 1, -7, 1 << 20], dtype=np.int64)
    for level in (1, 2, 3):
        np.testing.assert_array_equal(
            pn.recomposition_summand_q(v, level, BASE_LOG),
            jn.recomposition_summand_q(v, level, BASE_LOG))


# -- the modulus switch ---------------------------------------------------------

@pytest.mark.parametrize("poly_size", [N, 2048])
def test_modulus_switch_equals_tfhe_tpu(poly_size):
    """round(v * 2N / q) on 2^12 random values and the edges, including
    q - 1 -> 2N, against tfhe_tpu's Python-int switch."""
    vals = _random_values(seed=11)
    got = to_u64(pn.modulus_switch_nonnative(from_u64(vals, "cpu"),
                                             poly_size))
    np.testing.assert_array_equal(
        got, jn.modulus_switch_nonnative(vals, poly_size))
    assert int(got[-len(EDGES) + EDGES.index(Q - 1)]) == 2 * poly_size
    assert int(got.max()) <= 2 * poly_size


# -- keys and encryptions -------------------------------------------------------

def test_key_equals_tfhe_tpu(jax_run, port_run):
    """One seed, one key: the standard-domain key and its transform."""
    np.testing.assert_array_equal(to_u64(port_run["bsk_q"]), jax_run["bsk_q"])
    np.testing.assert_array_equal(to_u64(port_run["bsk_hat"]),
                                  jax_run["bsk_hat"])


def test_lwe_encryption_equals_tfhe_tpu(jax_run, port_run):
    np.testing.assert_array_equal(to_u64(port_run["cts"]), jax_run["cts"])
    phase = pn.lwe_decrypt_q(jax_run["lwe_sk"], port_run["cts"])
    np.testing.assert_array_equal(
        to_u64(phase), jn.lwe_decrypt_q(jax_run["lwe_sk"], jax_run["cts"]))
    np.testing.assert_array_equal(
        to_u64(pn.decode_q(phase, DELTA)),
        jn.decode_q(to_u64(phase), DELTA))


def test_glwe_encryption_equals_tfhe_tpu():
    rng_j, rng_p = np.random.default_rng(1), np.random.default_rng(1)
    sk = rng_j.integers(0, 2, size=(k, N)).astype(np.uint8)
    rng_p.integers(0, 2, size=(k, N))
    msgs = (np.random.default_rng(2).integers(0, MM, size=(3, N),
                                              dtype=np.uint64)
            * np.uint64(DELTA)) % np.uint64(Q)
    jct = jn.glwe_encrypt_q(sk, msgs, 3e3, rng_j)
    ct = pn.glwe_encrypt_q(sk, msgs, 3e3, rng_p, device="cpu")
    np.testing.assert_array_equal(to_u64(ct), jct)
    phase = pn.glwe_decrypt_q(sk, ct)
    np.testing.assert_array_equal(to_u64(phase), jn.glwe_decrypt_q(sk, jct))
    np.testing.assert_array_equal(to_u64(pn.decode_q(phase, DELTA)) % MM,
                                  (msgs // np.uint64(DELTA)) % MM)


def test_decode_edges_equal_tfhe_tpu():
    vals = _random_values(seed=13, count=256)
    for delta in (DELTA, 1 << 40, 3):
        np.testing.assert_array_equal(
            to_u64(pn.decode_q(from_u64(vals, "cpu"), delta)),
            jn.decode_q(vals, delta))


def test_key_refused_on_cuda_outside_envelope():
    """On a CUDA device, a shape K6 cannot hold is refused before any draw
    (no card needed: the refusal comes first)."""
    rng = np.random.default_rng(3)
    before = rng.bit_generator.state
    with pytest.raises(ValueError, match="K6's envelope|shared memory"):
        pn.gen_bootstrap_key_ntt64(np.ones(2, np.uint8),
                                   np.ones((1, 16384), np.uint8), 23, 1, 0.0,
                                   rng, device="cuda")
    with pytest.raises(ValueError, match="shared memory"):
        pn.gen_bootstrap_key_ntt64(np.ones(2, np.uint8),
                                   np.ones((2, 8192), np.uint8), 23, 1, 0.0,
                                   rng, device="cuda")
    with pytest.raises(ValueError, match="b\\*l < 64"):
        pn.gen_bootstrap_key_ntt64(np.ones(2, np.uint8),
                                   np.ones((1, 256), np.uint8), 16, 4, 0.0,
                                   rng, device="cuda")
    assert rng.bit_generator.state == before
    assert pk.ntt64_refusal(2, 1, 23, 2048) == ""
    assert pk.ntt64_smem_bytes(2, 1, 2048) == 96 * 1024


# -- rotation, extraction, LUT, PBS ---------------------------------------------

def test_monomial_products_equal_tfhe_tpu():
    import jax.numpy as jnp

    rng = np.random.default_rng(17)
    poly = rng.integers(0, Q, size=(5, k + 1, N), dtype=np.uint64)
    poly[:, :, :7] = 0
    deg = np.array([0, 1, N, 2 * N - 1, 2 * N], dtype=np.uint64)
    for port_fn, jax_fn in ((pn.monomial_mul_q, jn.monomial_mul_q),
                            (pn.monomial_div_q, jn.monomial_div_q)):
        got = port_fn(from_u64(poly, "cpu"), torch.from_numpy(
            deg.astype(np.int64))[:, None])
        want = np.asarray(jax_fn(jnp.asarray(poly),
                                 jnp.asarray(deg)[:, None, None]))
        np.testing.assert_array_equal(to_u64(got), want)


def test_blind_rotate_equals_tfhe_tpu(jax_run, port_run):
    """B = 4 with masks of 2N and 0 and bodies of 2N and 0: the rotation
    bit-equal, through the wrapper, which counts no launch on the CPU."""
    mask, body = _rotation_inputs()
    lut = from_u64(jax_run["lut"], "cpu")
    pk.reset_launches()
    got = pn.blind_rotate_ntt64(
        lut[None].expand(B, k + 1, N), torch.from_numpy(mask.astype(
            np.int64)), torch.from_numpy(body.astype(np.int64)),
        port_run["bsk_hat"], BASE_LOG, LEVELS)
    np.testing.assert_array_equal(to_u64(got), jax_run["rot"])
    assert pk.blind_rotate_ntt64.launches == 0


def test_cmux_steps_are_the_rotation_loop(jax_run, port_run):
    """K6's plain version on the body-rotated accumulator is the rotation:
    the split the kernel path takes."""
    mask, body = _rotation_inputs()
    lut = from_u64(jax_run["lut"], "cpu")[None].expand(B, k + 1, N)
    acc = pn.monomial_div_q(lut, torch.from_numpy(body.astype(np.int64))[
        :, None])
    got = pk.blind_rotate_ntt64_plain(acc, torch.from_numpy(
        mask.astype(np.int64)), port_run["bsk_hat"], BASE_LOG, LEVELS)
    np.testing.assert_array_equal(to_u64(got), jax_run["rot"])


@pytest.mark.parametrize("nth", [0, 5])
def test_sample_extract_equals_tfhe_tpu(jax_run, nth):
    got = pn.sample_extract_q(from_u64(jax_run["rot"], "cpu"), nth)
    want = jax_run["extract" if nth == 0 else "extract5"]
    np.testing.assert_array_equal(to_u64(got), want)


def test_generate_lut_equals_tfhe_tpu(jax_run, port_run):
    np.testing.assert_array_equal(port_run["lut"], jax_run["lut"])
    for mm, f in ((4, lambda x: 3 - x), (32, lambda x: x * x)):
        np.testing.assert_array_equal(
            pn.generate_lut_q(N, k + 1, mm, (1 << 63) // mm, f),
            jn.generate_lut_q(N, k + 1, mm, (1 << 63) // mm, f))


def test_pbs_equals_tfhe_tpu(jax_run, port_run):
    """The whole PBS from one seed: outputs bit-equal, decrypting to 2m
    (mod 2 * MM, the padding bit's space), no kernel launched."""
    np.testing.assert_array_equal(to_u64(port_run["out"]), jax_run["out"])
    assert pk.blind_rotate_ntt64.launches == 0
    big_sk = port_run["glwe_sk"].reshape(-1)
    dec = to_u64(pn.decode_q(pn.lwe_decrypt_q(big_sk, port_run["out"]),
                             DELTA))
    signed = np.array([int(v) - Q if int(v) > Q // 2 else int(v)
                       for v in dec])
    np.testing.assert_array_equal(signed % (2 * MM),
                                  (2 * 5 * np.arange(B)) % (2 * MM))


def test_carried_state_runs_the_same_pbs(jax_run):
    """tfhe_tpu's transformed key and ciphertexts carried in by
    ``convert`` give tfhe_tpu's PBS output (and the key carried in equals
    the port's own transform of tfhe_tpu's standard-domain key)."""
    from tfhe_tpu_torch import convert

    bsk_hat = convert.ntt64_bootstrap_key_from_arrays(jax_run["bsk_hat"],
                                                      device="cpu")
    assert torch.equal(bsk_hat, pn.bootstrap_key_to_ntt64(
        convert.ntt64_bootstrap_key_from_arrays(jax_run["bsk_q"], "cpu")))
    cts = convert.ntt64_ciphertexts_from_arrays(jax_run["cts"], device="cpu")
    out = pn.pbs_ntt64(cts, jax_run["lut"], bsk_hat, BASE_LOG, LEVELS)
    np.testing.assert_array_equal(to_u64(out), jax_run["out"])
