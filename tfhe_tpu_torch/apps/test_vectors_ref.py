"""Cross-library byte-exact test vectors: regenerate the reference's
``apps/test-vectors`` CBOR artifacts bit for bit, and check their SHA-256
against the Git-LFS *pointer* files of a reference checkout (each pointer
embeds ``oid sha256:<hash>`` of the real artifact, so cross-library
byte-exactness is checked offline, without fetching LFS data).

The port's twin of ``apps/test_vectors_ref.py``, on the port's own
``utils/csprng.py`` (AES-CTR from ``TableIndex::SECOND``, the fork budgets)
and ``utils/cbor.py``: :func:`generate` is byte-equal to ``tfhe_tpu``'s for
each of the 10 reproducible artifacts and every ``_internal`` array.

Reference recipe (apps/test-vectors/src/main.rs, data/README.md):
  RAND_SEED = 0x74666865, MSG_A = 4, MSG_B = 3, msg_bits = 4 (delta 2^59),
  KS->PBS atomic pattern intermediates for toy (n=10, k=1, N=256, zero
  noise, pbs 24/1, ks 37/1) and valid_params_128 (n=833, k=1, N=2048,
  gaussian noise, pbs 23/1, ks 3/5) parameters.

Every byte-relevant behavior is reproduced exactly:
  - tfhe-csprng AES-128-CTR streams starting at TableIndex::SECOND
    (= byte offset 1: generic.rs:63 ``start_index.unwrap_or(SECOND)``),
    key = seed LE bytes, block input = counter LE (soft block_cipher.rs);
  - DeterministicSeeder noise seed = first 16 stream bytes as LE u128
    (generators/seeder.rs:49, uniform.rs:17);
  - draw orders: secret keys 1 byte/bit (uniform_binary.rs); LWE encrypt =
    mask u64s then ONE gaussian pair (first kept) (lwe_encryption.rs:67);
    noise SLICES draw one full pair per element, second discarded
    (random/mod.rs:74 fill_slice + gaussian.rs:151 scalar generate_one);
  - fork budgets: list encryption forks per ciphertext, BSK forks
    n -> levels -> rows; gaussian noise budget = 16 * 58 bytes per element
    (noise_random_generator.rs:33-56);
  - KSK plaintext order level l..1 (lwe_keyswitch_key_generation.rs rev());
    GGSW factor = (-cleartext) << (64 - blog*level), last row body[0] =
    +cleartext << shift (ggsw_encryption.rs:20-44, :318);
  - keyswitch: out = (0..0, b) - sum_i sum_l ksk[i][l] * digit_l(a_i) with
    the balanced signed decomposition, iterator level l first
    (lwe_keyswitch.rs, decomposition/iter.rs:296);
  - modulus switch: (x + 2^(64-log-1)) >> (64-log), stored MSB-aligned
    with custom modulus 2N (fft_impl/common.rs:10, main.rs:95);
  - ciborium CBOR layouts (``utils/cbor.py``).

The BSK's rows are drawn as ``tfhe_tpu`` draws them and computed at once:
each row's noise slice from one bulk read of its fork (the i-th accepted
Marsaglia pair is the i-th element's; the fork is thrown away after its
slice, so reading past the last accepted pair changes nothing), with the
float operations of the scalar sampler in its order (``math.log`` on each
accepted pair); the mask products as exact 16-bit-limb products in float64
(every sum below 2^27). So ``valid_params_128`` takes seconds, not minutes.

The four post-blind-rotation artifacts (glwe_after_*_br, lwe_after_*_pbs)
are not byte-reproducible by design: the reference computes them with its
f64 FFT, whose rounding errors are baked into the stored bytes. They are
checked at the decryption level instead (:func:`decrypt_contract`: the
port's exact PBS, K2 u64 -> K3 at P = 4, on the byte-identical keys and
input decodes to A with the identity LUT and to 2A mod 16 with the spec
LUT, the contract the reference asserts in main.rs).

Usage: python -m tfhe_tpu_torch.apps.test_vectors_ref [toy|valid]
           [--reference TFHE_RS_CHECKOUT] [--write OUTDIR] [--device DEVICE]

(``--reference``: a tfhe-rs checkout whose ``apps/test-vectors/data`` holds
the pointers, else the digests are compared with ``TOY_SHA256`` /
``VALID_SHA256``; ``--device``: where the decryption contract runs, the GPU
when left out, ``cpu`` for the plain versions.)
"""

from __future__ import annotations

import hashlib
import math
import os
import re
import sys

import numpy as np

from ..utils import cbor
from ..utils.csprng import AesCtrGenerator

RAND_SEED = 0x74666865
MSG_A, MSG_B = 4, 3
MSG_BITS = 4
LOG_DELTA = 64 - MSG_BITS - 1  # 59

TOY = dict(n=10, k=1, N=256, lwe_std=0.0, glwe_std=0.0,
           pbs_blog=24, pbs_l=1, ks_blog=37, ks_l=1)
VALID = dict(n=833, k=1, N=2048,
             lwe_std=3.6158408373309336e-06, glwe_std=2.845267479601915e-15,
             pbs_blog=23, pbs_l=1, ks_blog=3, ks_l=5)

#: SHA-256 of each reproducible TOY artifact, as :func:`generate` writes
#: them on the CPU (equal to ``tfhe_tpu``'s, and, by its own run against
#: the pointers, to the reference's oids)
TOY_SHA256 = {
    "bsk": "7cc6803f5fbc3d5a1bf597f2b979ce17eecd3d6baca12183dea21022a7b65c52",
    "ksk": "377761beeb4216cf5aa2624a8b64b8259f5a75c32d28e850be8bced3a0cdd6f5",
    "large_lwe_secret_key":
        "c7d5a864d5616a7d8ad50bbf40416e41e6c9b60c546dc14d4aa8fc40a418baa7",
    "lwe_a":
        "c9eb75bd2993639348a679cf48c06e3c38d1a513f48e5b0ce0047cea8cff6bbc",
    "lwe_b":
        "eadf2eff35133ffba075df11faecddd6e7af9ddc398011ec4568e5528812b3e2",
    "lwe_ks":
        "d6da5baef0e787f6be56e218d8354e26904652602db964844156fdff08350ce6",
    "lwe_ms":
        "c6df98676de04fe54b5ffc2eb30a82ebb706c9d7d5a4e0ed509700fec88761f7",
    "lwe_prod":
        "837b3bd3245d4d0534ed255fdef896fb4fa6998a258a14543dfdadd0bfc9b6dd",
    "lwe_sum":
        "699580ca92b9c2f9e1f57fb1e312c9e8cb29714f7acdef9d2ba05f798546751f",
    "small_lwe_secret_key":
        "ee9fcf45f1379ca3a7d7bf2b0e7a1cc920ceb496c0217e8604b0b58d2831749e",
}

#: the same for ``valid_params_128`` (equal to ``tfhe_tpu``'s generation,
#: byte for byte, on the CPU)
VALID_SHA256 = {
    "bsk":
        "e9afe7019acba5cda926f13e06df9930571611729d2f2e8ce41956e1f5e1db6f",
    "ksk":
        "e591ab9af1b6a0aede273f9a3abb65a4c387feb5fa06a6959e9314058ca0f7e5",
    "large_lwe_secret_key":
        "b7a037b9eaa88d6385167579b93e26a0cb6976d9b8967416fd1173e113bda199",
    "lwe_a":
        "e69d2d2c064fc8c0460b39191ca65338146990349954f5ec5ebd01d93610e7eb",
    "lwe_b":
        "c806533b325b1009db38be2f9bef5f3b2fad6b77b4c71f2855ccc9d3b4162e98",
    "lwe_ks":
        "59dba26d457f96478eda130cab5301fce86f23c6a8807de42f2a1e78c4985ca7",
    "lwe_ms":
        "aa44aea29efd6d9e4d35a21a625d9cba155672e3f7ed3eddee1e211e62ad146b",
    "lwe_prod":
        "e76c24b2a0c9a842ad13dda35473c2514f9e7d20983b5ea0759c4521a91626d9",
    "lwe_sum":
        "7f3c40a134623b44779a556212477fea26eaed22450f3b6faeb8721d63699972",
    "small_lwe_secret_key":
        "2c70d1d78cc3760733850a353ace2b9c4705e840141b75841739e90e51247e18",
}

GAUSSIAN_PAIR_BYTES = 16
GAUSSIAN_ATTEMPTS = 58  # ceil(-128 / log2(1 - pi/4))
NOISE_BYTES_PER_ELEM = GAUSSIAN_PAIR_BYTES * GAUSSIAN_ATTEMPTS  # 928
CONTRACT_PRIMES = 4  # the exact CRT key of the decryption contract

_U64 = np.uint64


def _WRAP():
    return np.errstate(over="ignore")


def _rust_round(x: float) -> int:
    return int(math.floor(x + 0.5)) if x >= 0 else int(math.ceil(x - 0.5))


def _from_torus(x: float) -> int:
    """FromTorus<f64> for u64 (math/torus/mod.rs:72)."""
    fract = x - _rust_round(x)
    return _rust_round(fract * (2.0 ** 64)) % (1 << 64)


def _round_half_away(x: np.ndarray) -> np.ndarray:
    """:func:`_rust_round` on float64 arrays (as float64)."""
    return np.where(x >= 0, np.floor(x + 0.5), np.ceil(x - 0.5))


def _from_torus_array(x: np.ndarray) -> np.ndarray:
    """:func:`_from_torus` on float64 arrays, as uint64."""
    r = _round_half_away((x - _round_half_away(x)) * 2.0 ** 64)
    mag = np.abs(r).astype(_U64)  # |r| <= 2^63
    with _WRAP():
        return np.where(r < 0, np.negative(mag), mag)


def _gaussian_one(gen: AesCtrGenerator, std: float) -> int:
    """Scalar Torus gaussian generate_one: draw pairs until accepted, keep
    the FIRST value only (gaussian.rs:40-70,151-163)."""
    while True:
        raw = gen.next_bytes(16)
        u = int.from_bytes(bytes(raw[:8].tolist()), "little", signed=True)
        v = int.from_bytes(bytes(raw[8:].tolist()), "little", signed=True)
        uf = float(u) * 2.0 ** -63
        vf = float(v) * 2.0 ** -63
        s = uf * uf + vf * vf
        if 0.0 < s < 1.0:
            cst = std * math.sqrt(-2.0 * math.log(s) / s)
            return _from_torus(uf * cst)


def _gaussian_slice(gen: AesCtrGenerator, count: int,
                    std: float) -> np.ndarray:
    """Per-element scalar draws (fill_slice default, random/mod.rs:74):
    element i keeps the first value of the i-th accepted pair of ``gen``'s
    stream. Read in bulk, so ``gen`` is left past its last accepted pair:
    only for a fork that is thrown away after the slice."""
    us, ss = [], []
    need = count
    while need:
        raw = gen.next_bytes(GAUSSIAN_PAIR_BYTES * (need + need // 2 + 16))
        pairs = raw.view("<i8").astype(np.float64) * 2.0 ** -63
        u, v = pairs[0::2], pairs[1::2]
        s = u * u + v * v
        ok = np.flatnonzero((s > 0.0) & (s < 1.0))[:need]
        us.append(u[ok])
        ss.append(s[ok])
        need -= ok.size
    u, s = np.concatenate(us), np.concatenate(ss)
    log_s = np.array([math.log(x) for x in s.tolist()], dtype=np.float64)
    return _from_torus_array(u * (std * np.sqrt(-2.0 * log_s / s)))


def _negacyclic_binary_polymul(masks: np.ndarray,
                               s_bits: np.ndarray) -> np.ndarray:
    """Each row of ``masks`` (u64[rows, N]) times s (binary[N]) mod
    (X^N + 1, 2^64): exact, as four 16-bit limbs each multiplied in float64
    by the negacyclic matrix of s (every sum below 2^27)."""
    N = s_bits.shape[0]
    i = np.arange(N)
    d = i[None, :] - i[:, None]  # [i, t] -> t - i
    s = s_bits.astype(np.float64)[d % N]
    mat = np.where(d >= 0, s, -s)  # out[t] = sum_i mask[i] * mat[i, t]
    out = np.zeros(masks.shape, dtype=_U64)
    with _WRAP():
        for k in range(4):
            limb = ((masks >> _U64(16 * k)) & _U64(0xFFFF)).astype(np.float64)
            part = (limb @ mat).astype(np.int64).astype(_U64)
            out += part << _U64(16 * k)
    return out


def _lwe_encrypt(mask_gen, noise_gen, sk_bits, pt: int, std: float) -> np.ndarray:
    mask = mask_gen.uniform_u64(len(sk_bits))
    e = _gaussian_one(noise_gen, std)
    with _WRAP():
        body = _U64((int((mask * sk_bits).sum(dtype=_U64)) + pt + e) % (1 << 64))
    return np.concatenate([mask, np.array([body], dtype=_U64)])


def _decompose_digits(val: int, blog: int, levels: int) -> list:
    """Balanced signed decomposition, iterator order level l..1
    (decomposer.rs init_decomposer_state + iter.rs decompose_one_level)."""
    non_rep = 64 - levels * blog
    res = val >> (non_rep - 1)
    rounding_bit = res & 1
    res = (res + 1) >> 1
    rep = levels * blog
    res &= (1 << rep) - 1
    need_balance = (((res - 1) | (rounding_bit << (rep - 1))) & res) >> (rep - 1)
    state = res - (need_balance << rep)  # signed python int
    digits = []
    B = 1 << blog
    for _ in range(levels):
        r = state & (B - 1)
        state >>= blog
        carry = 1 if (r > B // 2 or (r == B // 2 and (state % B) >= B // 2)) else 0
        state += carry
        digits.append(r - (carry << blog))
    return digits  # digits[j] pairs with ksk block[j] (level l - j)


def _bootstrap_key(p: dict, mask_gen, noise_gen, glwe_bits: np.ndarray,
                   small_bits: np.ndarray) -> np.ndarray:
    """The BSK u64[n, l, R, R, N]: every GGSW row's mask and noise drawn
    from its fork (n -> levels -> rows) as the reference draws them, then
    the bodies of all rows at once."""
    n, k, N = p["n"], p["k"], p["N"]
    pbs_blog, pbs_l = p["pbs_blog"], p["pbs_l"]
    R = k + 1
    glwe_polys = glwe_bits.reshape(k, N)
    m_ggsw = mask_gen.try_fork(n, pbs_l * R * k * N * 8)
    n_ggsw = noise_gen.try_fork(n, pbs_l * R * N * NOISE_BYTES_PER_ELEM)
    masks = np.empty((n, pbs_l, R, k, N), dtype=_U64)
    noise = np.empty((n, pbs_l, R, N), dtype=_U64)
    for i in range(n):
        m_lvl = m_ggsw[i].try_fork(pbs_l, R * k * N * 8)
        n_lvl = n_ggsw[i].try_fork(pbs_l, R * N * NOISE_BYTES_PER_ELEM)
        for m in range(pbs_l):
            m_rows = m_lvl[m].try_fork(R, k * N * 8)
            n_rows = n_lvl[m].try_fork(R, N * NOISE_BYTES_PER_ELEM)
            for r in range(R):
                masks[i, m, r] = m_rows[r].uniform_u64(k * N).reshape(k, N)
                noise[i, m, r] = _gaussian_slice(n_rows[r], N, p["glwe_std"])
    # factor = (-bit) << (64 - blog * level), level = l - m
    shifts = np.array([64 - pbs_blog * (pbs_l - m) for m in range(pbs_l)],
                      dtype=_U64)
    with _WRAP():
        factor = np.negative(small_bits)[:, None] << shifts[None, :]
        body = np.zeros((n, pbs_l, R, N), dtype=_U64)
        body[:, :, :k] = glwe_polys[None, None] * factor[:, :, None, None]
        body[:, :, k, 0] = np.negative(factor)
        body += noise
        for kk in range(k):
            body += _negacyclic_binary_polymul(
                masks[:, :, :, kk].reshape(-1, N),
                glwe_polys[kk]).reshape(n, pbs_l, R, N)
    bsk = np.empty((n, pbs_l, R, R, N), dtype=_U64)
    bsk[:, :, :, :k] = masks
    bsk[:, :, :, k] = body
    return bsk


def generate(p: dict) -> dict:
    n, k, N = p["n"], p["k"], p["N"]
    files = {}

    # --- streams (all start at TableIndex::SECOND = byte offset 1) -------
    secret = AesCtrGenerator(RAND_SEED, table_index=1)
    seeder = AesCtrGenerator(RAND_SEED, table_index=1)
    noise_seed = int.from_bytes(bytes(seeder.next_bytes(16).tolist()), "little")
    mask_gen = AesCtrGenerator(RAND_SEED, table_index=1)
    noise_gen = AesCtrGenerator(noise_seed, table_index=1)

    # --- secret keys ------------------------------------------------------
    glwe_bits = secret.uniform_binary(k * N)
    small_bits = secret.uniform_binary(n)
    files["large_lwe_secret_key"] = cbor.lwe_secret_key_bytes(glwe_bits)
    files["small_lwe_secret_key"] = cbor.lwe_secret_key_bytes(small_bits)

    # --- lwe_a / lwe_b (large key, GLWE noise dist — main.rs:166,178) ----
    lwe_a = _lwe_encrypt(mask_gen, noise_gen, glwe_bits,
                         MSG_A << LOG_DELTA, p["glwe_std"])
    lwe_b = _lwe_encrypt(mask_gen, noise_gen, glwe_bits,
                         MSG_B << LOG_DELTA, p["glwe_std"])
    files["lwe_a"] = cbor.lwe_ciphertext_bytes(lwe_a)
    files["lwe_b"] = cbor.lwe_ciphertext_bytes(lwe_b)
    with _WRAP():
        files["lwe_sum"] = cbor.lwe_ciphertext_bytes(lwe_a + lwe_b)
        files["lwe_prod"] = cbor.lwe_ciphertext_bytes(lwe_a * _U64(MSG_B))

    # --- ksk (large -> small, LWE noise dist) -----------------------------
    ks_blog, ks_l = p["ks_blog"], p["ks_l"]
    ksk_rows = []
    for bit in glwe_bits.tolist():
        # encrypt_lwe_ciphertext_list forks one child per level ciphertext
        m_kids = mask_gen.try_fork(ks_l, n * 8)
        n_kids = noise_gen.try_fork(ks_l, NOISE_BYTES_PER_ELEM)
        for j in range(ks_l):
            level = ks_l - j
            pt = (bit << (64 - ks_blog * level)) % (1 << 64)
            ksk_rows.append(_lwe_encrypt(m_kids[j], n_kids[j], small_bits,
                                         pt, p["lwe_std"]))
    ksk = np.stack(ksk_rows)  # [k*N*l, n+1]
    files["ksk"] = cbor.lwe_keyswitch_key_bytes(
        ksk.reshape(-1), ks_blog, ks_l, n + 1)

    # --- keyswitch lwe_a -> lwe_ks ----------------------------------------
    out = np.zeros(n + 1, dtype=_U64)
    out[n] = lwe_a[k * N]
    with _WRAP():
        for i in range(k * N):
            digits = _decompose_digits(int(lwe_a[i]), ks_blog, ks_l)
            for j, d in enumerate(digits):
                row = ksk[i * ks_l + j]
                out = out - row * _U64(d % (1 << 64))
    files["lwe_ks"] = cbor.lwe_ciphertext_bytes(out)

    # --- bsk (small bits GGSW-encrypted under GLWE key, GLWE noise) -------
    bsk = _bootstrap_key(p, mask_gen, noise_gen, glwe_bits, small_bits)
    files["bsk"] = cbor.lwe_bootstrap_key_bytes(
        bsk.reshape(-1), k + 1, N, p["pbs_blog"], p["pbs_l"])

    # --- modulus switch of lwe_ks -----------------------------------------
    log_mod = int(2 * N).bit_length() - 1  # to_blind_rotation_input_modulus_log
    with _WRAP():
        ms = (out + _U64(1 << (64 - log_mod - 1))) >> _U64(64 - log_mod)
    files["lwe_ms"] = cbor.lwe_ciphertext_bytes(
        ms << _U64(64 - log_mod), modulus=1 << log_mod)

    # internal extras for decryption-level checks (not reference artifacts)
    files["_internal"] = dict(
        glwe_bits=glwe_bits, small_bits=small_bits, lwe_ks=out, lwe_ms=ms,
        bsk=bsk, ksk=ksk, params=dict(p))
    return files


def digests(files: dict) -> dict:
    """SHA-256 (hex) of each reproducible artifact of :func:`generate`."""
    return {name: hashlib.sha256(blob).hexdigest()
            for name, blob in files.items() if not name.startswith("_")}


def reference_lut(f, N: int, k: int) -> np.ndarray:
    """The reference's LUT layout (generate_programmable_bootstrap_glwe_lut)
    of ``f`` on MSG_BITS-bit messages, u64[k+1, N]: boxes of N / 2^bits,
    rotated by half a box with the negacyclic sign."""
    mm = 1 << MSG_BITS
    box = N // mm
    body = np.zeros(N, dtype=_U64)
    for i in range(mm):
        body[i * box:(i + 1) * box] = _U64((f(i) << LOG_DELTA) % (1 << 64))
    half = box // 2
    with _WRAP():
        body = np.concatenate([body[half:], np.negative(body[:half])])
    lut = np.zeros((k + 1, N), dtype=_U64)
    lut[k] = body
    return lut


def contract_luts() -> tuple:
    """(tag, function, expected decryption of lwe_ms) of the two blind
    rotations of the contract (main.rs): identity -> A, spec -> 2A mod 16."""
    mm = 1 << MSG_BITS
    return (("id", lambda x: x, MSG_A),
            ("spec", lambda x: (2 * x) % mm, (2 * MSG_A) % mm))


def pbs_inputs(files: dict, device=None) -> dict:
    """The decryption contract's PBS inputs on ``device`` (the GPU when
    unset): the exact CRT key of the BSK in scan layout (P =
    CONTRACT_PRIMES), lwe_ms's mask [1, n] and body [1], and each LUT of
    :func:`contract_luts` as int64[k+1, N]."""
    from .._device import resolve_device
    from .._torus import from_u64
    from ..core import algorithms as algo
    from ..core.entities import LweBootstrapKey
    from ..ops import pbs_kernel as pk

    dev = resolve_device(device)
    internal = files["_internal"]
    p = internal["params"]
    std = LweBootstrapKey(from_u64(internal["bsk"], dev), p["pbs_blog"],
                          p["pbs_l"])
    key = pk.bsk_to_scan_layout(
        algo.bootstrap_key_to_ntt(std, CONTRACT_PRIMES).residues)
    ms = internal["lwe_ms"]
    return dict(key=key, mask=from_u64(ms[None, :-1], dev),
                body=from_u64(ms[-1:], dev),
                luts={tag: from_u64(reference_lut(f, p["N"], p["k"]), dev)
                      for tag, f, _ in contract_luts()})


def decrypt_contract(files: dict, device=None) -> dict:
    """``tests/test_ref_vectors.py``'s decryption-level check on the port's
    exact PBS, on ``device`` (the GPU when unset): lwe_ms through K2 u64 ->
    K3 (``pbs_kernel.body_rotate_u64``, ``blind_rotate_crt``) on the BSK's
    exact CRT key, sample-extracted and decrypted under the large key, must
    decode to MSG_A with the identity LUT and to 2 MSG_A mod 16 with the
    spec LUT. Returns {tag: decoded}; raises AssertionError otherwise."""
    from .._torus import to_u64
    from ..ops import pbs_kernel as pk
    from ..ops import server as server_ops

    internal = files["_internal"]
    p = internal["params"]
    inputs = pbs_inputs(files, device)
    mm, delta = 1 << MSG_BITS, 1 << LOG_DELTA
    got = {}
    for tag, _, expect in contract_luts():
        acc = pk.body_rotate_u64(inputs["luts"][tag], inputs["body"])
        rotated = pk.blind_rotate_crt(acc, inputs["mask"], inputs["key"],
                                      p["pbs_blog"], p["pbs_l"])
        out = to_u64(server_ops.sample_extract(rotated, 0))[0]
        with _WRAP():
            phase = int(out[-1]) - int(
                (out[:-1] * internal["glwe_bits"]).sum(dtype=_U64))
        phase %= 1 << 64
        got[tag] = ((phase + (delta // 2)) >> LOG_DELTA) % mm
        if got[tag] != expect:
            raise AssertionError(f"decryption contract, {tag} LUT: decodes "
                                 f"to {got[tag]}, expected {expect}")
    return got


def reference_oids(param_dir: str, reference: str = None) -> dict:
    """{artifact: (sha256 oid, size)} from the Git-LFS pointers of
    ``<reference>/apps/test-vectors/data/<param_dir>`` (``reference``: a
    tfhe-rs checkout); {} when there is none."""
    if not reference:
        return {}
    base = os.path.join(reference, "apps", "test-vectors", "data", param_dir)
    if not os.path.isdir(base):
        return {}
    oids = {}
    for fn in sorted(os.listdir(base)):
        if not fn.endswith(".cbor"):
            continue
        with open(os.path.join(base, fn)) as f:
            txt = f.read()
        m = re.search(r"oid sha256:([0-9a-f]{64})", txt)
        sz = re.search(r"size (\d+)", txt)
        if m:
            oids[fn[:-5]] = (m.group(1), int(sz.group(1)) if sz else -1)
    return oids


def _option(argv: list, flag: str):
    return argv[argv.index(flag) + 1] if flag in argv else None


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    which = argv[0] if argv and not argv[0].startswith("--") else "toy"
    p, d = (TOY, "toy_params") if which == "toy" else (VALID, "valid_params_128")
    files = generate(p)
    print(f"decryption contract ({which}): "
          f"{decrypt_contract(files, _option(argv, '--device'))}")
    oids = reference_oids(d, _option(argv, "--reference"))
    if not oids:
        print("no reference checkout: comparing with the digests of "
              f"{which.upper()}_SHA256")
        oids = {k: (v, len(files[k])) for k, v in
                (TOY_SHA256 if which == "toy" else VALID_SHA256).items()}
    n_match = n_diff = 0
    for name, got in sorted(digests(files).items()):
        want, want_size = oids.get(name, ("<missing>", -1))
        status = "MATCH" if got == want else "differ"
        if got == want:
            n_match += 1
        else:
            n_diff += 1
        print(f"{status:7s} {name:24s} size {len(files[name])}/{want_size} "
              f"sha256 {got[:16]} / {want[:16]}")
    skipped = sorted(set(oids) - set(files))
    print(f"{n_match} byte-exact matches, {n_diff} mismatches; "
          f"not byte-reproducible (f64-FFT artifacts): {skipped}")
    outdir = _option(argv, "--write")
    if outdir:
        os.makedirs(outdir, exist_ok=True)
        for name, blob in files.items():
            if not name.startswith("_"):
                with open(os.path.join(outdir, f"{name}.cbor"), "wb") as f:
                    f.write(blob)
    return n_diff


if __name__ == "__main__":
    sys.exit(main())
