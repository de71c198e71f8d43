"""Carry keys and ciphertexts made by tfhe_tpu into the port.

Every function takes plain numpy arrays (what ``np.asarray`` of a
``tfhe_tpu`` key or ciphertext gives), so the port and the JAX package can
compute on identical keys and inputs without the port importing either JAX
or ``tfhe_tpu``.
"""

from __future__ import annotations

import numpy as np

from . import boolean
from ._device import resolve_device
from ._torus import from_u32, from_u64, to_u32, to_u64
from .core.entities import GlweSecretKey, LweSecretKey
from .core.squash import GlweSecretKey128
from .integer import radix
from .shortint import list_compression as lc
from .shortint.client_key import ClientKey
from .shortint.compact_public_key import CompactPrivateKey, CompactPublicKey
from .shortint.compressed_server_key import CompressedServerKey
from .shortint import noise_squashing as ns
from .shortint import noise_squashing_compression as nsc
from .shortint.key_switching_key import KeySwitchingKey, ksk_limbs
from .shortint.public_key import PublicKey
from .shortint.server_key import ServerKey
from .shortint.wopbs import WopbsKey
from .strings.ascii import FheAsciiString
from .utils.params import BOOLEAN_PARAMS_BY_NAME, PARAMS_BY_NAME


def client_key_from_arrays(params_name: str, glwe_sk_bits, lwe_sk_bits,
                           device=None) -> ClientKey:
    """A port ClientKey from secret-key bits u64[k, N] and u64[n], for any
    name of ``PARAMS_BY_NAME`` (the universe's names included). It
    decrypts; it carries no random streams, so it does not encrypt."""
    dev = resolve_device(device)
    return ClientKey(params=PARAMS_BY_NAME[params_name],
                     glwe_sk=GlweSecretKey(from_u64(glwe_sk_bits, dev)),
                     lwe_sk=LweSecretKey(from_u64(lwe_sk_bits, dev)),
                     device=dev)


def client_key_to_arrays(ck: ClientKey) -> tuple:
    """Inverse of :func:`client_key_from_arrays`: (params name, GLWE key
    bits u64[k, N], LWE key bits u64[n])."""
    return ck.params.name, to_u64(ck.glwe_sk.bits), to_u64(ck.lwe_sk.bits)


def server_key_from_arrays(params_name: str, ksk_u64,
                           bsk_scan_residues_u32, num_primes: int,
                           device=None, ms_zeros_u64=None) -> ServerKey:
    """A port ServerKey from ``tfhe_tpu``'s stored key arrays, for any name
    of ``PARAMS_BY_NAME`` (:meth:`ServerKey.from_stored`: the KSK, the CRT
    key in scan layout (a multi-bit set's residue layout), its prime count
    and the drift technique's encryptions of zero)."""
    return ServerKey.from_stored(PARAMS_BY_NAME[params_name], ksk_u64,
                                 bsk_scan_residues_u32, num_primes, device,
                                 ms_zeros_u64)


def server_key_to_arrays(sk: ServerKey) -> tuple:
    """Inverse of :func:`server_key_from_arrays`: (params name, KSK u64,
    CRT key in scan layout u32 (a multi-bit key: ``tfhe_tpu``'s residue
    layout), its prime count, the encryptions of zero u64 or None)."""
    zeros = None if sk.ms_zeros is None else to_u64(sk.ms_zeros)
    bsk = sk.stored_bsk()  # P on axis 2, a multi-bit key's on axis 1
    return (sk.params.name, to_u64(sk.ksk), to_u32(bsk),
            bsk.shape[1 if sk.bsk_mb is not None else 2], zeros)


def boolean_client_key_from_arrays(params_name: str, glwe_sk_bits,
                                   lwe_sk_bits,
                                   device=None) -> boolean.ClientKey:
    """A port boolean ClientKey from secret-key bits u64[k, N] and u64[n].
    It decrypts; it carries no random streams, so it does not encrypt."""
    dev = resolve_device(device)
    return boolean.ClientKey(
        params=BOOLEAN_PARAMS_BY_NAME[params_name],
        glwe_sk=GlweSecretKey(from_u64(glwe_sk_bits, dev)),
        lwe_sk=LweSecretKey(from_u64(lwe_sk_bits, dev)), device=dev)


def boolean_server_key_from_arrays(params_name: str, ksk_u64,
                                   bsk_scan_u32,
                                   device=None) -> boolean.ServerKey:
    """A port boolean ServerKey from ``tfhe_tpu``'s stored key arrays: the
    KSK u64[k*N, l_ks, n+1] and the CRT key in scan layout
    u32[n, 2, P, l*R, R, N], taken as stored (the port's NTT plan gives the
    same residue order)."""
    dev = resolve_device(device)
    return boolean.ServerKey.from_keys(
        BOOLEAN_PARAMS_BY_NAME[params_name], from_u64(ksk_u64, dev),
        from_u32(bsk_scan_u32, dev))


def integer_keys_from_arrays(params_name: str, glwe_sk_bits, lwe_sk_bits,
                             ksk_u64, bsk_scan_residues_u32, num_primes: int,
                             device=None, ms_zeros_u64=None):
    """The port's integer (ClientKey, ServerKey) over the shortint keys of
    :func:`client_key_from_arrays` and :func:`server_key_from_arrays`, which
    take these arrays. The client key decrypts; it does not encrypt."""
    ck = client_key_from_arrays(params_name, glwe_sk_bits, lwe_sk_bits,
                                device)
    sk = server_key_from_arrays(params_name, ksk_u64, bsk_scan_residues_u32,
                                num_primes, device, ms_zeros_u64)
    return radix.ClientKey(ck), radix.ServerKey(sk)


def radix_ciphertext_from_arrays(ct_u64, degrees, noise_levels,
                                 message_modulus: int, carry_modulus: int,
                                 device=None) -> radix.RadixCiphertext:
    """A port RadixCiphertext from ``tfhe_tpu``'s: the blocks
    u64[..., num_blocks, dim+1] and the per-block degrees and noise levels
    int[num_blocks] (copied, so the two never share bookkeeping)."""
    dev = resolve_device(device)
    ct = from_u64(ct_u64, dev)
    nb = ct.shape[-2]
    degrees = np.array(degrees, dtype=np.int64)
    noise_levels = np.array(noise_levels, dtype=np.int64)
    if degrees.shape != (nb,) or noise_levels.shape != (nb,):
        raise ValueError(f"{nb} blocks need {nb} degrees and noise levels, "
                         f"got {degrees.shape} and {noise_levels.shape}")
    return radix.RadixCiphertext(ct=ct, degrees=degrees,
                                 noise_levels=noise_levels,
                                 message_modulus=message_modulus,
                                 carry_modulus=carry_modulus)


def radix_ciphertext_to_arrays(ct: radix.RadixCiphertext) -> tuple:
    """Inverse of :func:`radix_ciphertext_from_arrays`: (blocks u64[...,
    num_blocks, dim+1], degrees, noise_levels, message_modulus,
    carry_modulus), all numpy or int."""
    return (to_u64(ct.ct), np.array(ct.degrees, dtype=np.int64),
            np.array(ct.noise_levels, dtype=np.int64), ct.message_modulus,
            ct.carry_modulus)


def ascii_string_from_arrays(chars_u64, degrees, noise_levels,
                             message_modulus: int, carry_modulus: int,
                             capacity: int, device=None) -> FheAsciiString:
    """A port FheAsciiString from ``tfhe_tpu``'s: its chars' blocks
    u64[capacity, num_blocks, dim+1], their per-block degrees and noise
    levels, and the capacity (see :func:`radix_ciphertext_from_arrays`)."""
    chars = radix_ciphertext_from_arrays(chars_u64, degrees, noise_levels,
                                         message_modulus, carry_modulus,
                                         device)
    if chars.ct.shape[0] != capacity:
        raise ValueError(f"capacity {capacity} does not match the "
                         f"{chars.ct.shape[0]} chars given")
    return FheAsciiString(chars=chars, capacity=capacity)


def ascii_string_to_arrays(s: FheAsciiString) -> tuple:
    """Inverse of :func:`ascii_string_from_arrays`: (chars u64[capacity,
    num_blocks, dim+1], degrees, noise_levels, message_modulus,
    carry_modulus, capacity)."""
    return radix_ciphertext_to_arrays(s.chars) + (s.capacity,)


# -- the shortint side modules ------------------------------------------------
# Their parameter sets (compact-PK, casting, compression) are the port's own
# objects, given by the caller: the test sets among them have no name the
# port can look up.

def public_key_from_arrays(params_name: str, zeros_u64,
                           device=None) -> PublicKey:
    """A PublicKey from ``tfhe_tpu``'s ``PublicKey.zeros`` u64[count, n+1]."""
    return PublicKey(zeros=from_u64(zeros_u64, resolve_device(device)),
                     params=PARAMS_BY_NAME[params_name])


def compact_private_key_from_arrays(params, bits_u64,
                                    device=None) -> CompactPrivateKey:
    """A CompactPrivateKey from its key bits u64[n]: it decrypts expanded
    lists; it carries no generator, so it makes no public key."""
    return CompactPrivateKey(
        lwe_sk=LweSecretKey(from_u64(bits_u64, resolve_device(device))),
        params=params)


def compact_public_key_from_arrays(params, mask_u64, body_u64,
                                   device=None) -> CompactPublicKey:
    """A CompactPublicKey from ``tfhe_tpu``'s mask and body u64[n]."""
    dev = resolve_device(device)
    return CompactPublicKey(mask=from_u64(mask_u64, dev),
                            body=from_u64(body_u64, dev), params=params)


def key_switching_key_from_arrays(params, ksk_u64, dest_server_key,
                                  dest_under: str, cast_rshift: int,
                                  src_server_key=None) -> KeySwitchingKey:
    """A KeySwitchingKey from ``tfhe_tpu``'s ``ksk`` u64[n_src, l,
    n_dst+1] and its bookkeeping, on the destination key's device."""
    ksk = from_u64(ksk_u64, dest_server_key.device)
    return KeySwitchingKey(ksk=ksk, ksk_i8=ksk_limbs(ksk), params=params,
                           dest_server_key=dest_server_key,
                           src_server_key=src_server_key,
                           cast_rshift=cast_rshift, dest_under=dest_under)


def compression_keys_from_arrays(params, comp_glwe_sk_bits, pksk_hat_u64,
                                 num_primes: int, dec_bsk_scan_u32,
                                 dec_num_primes: int, device=None) -> tuple:
    """(CompressionPrivateKeys, CompressionKey, DecompressionKey) from
    ``tfhe_tpu``'s: the compression GLWE key bits u64[k_c, N_c], the
    packing key's residues u64[P, n_big, l, R_c, N_c] and the decompression
    key in scan layout u32[k_c*N_c, 2, P', l*R, R, N]."""
    dev = resolve_device(device)
    return (lc.CompressionPrivateKeys(
                comp_glwe_sk=GlweSecretKey(from_u64(comp_glwe_sk_bits, dev)), params=params),
            lc.CompressionKey(pksk_hat=from_u64(pksk_hat_u64, dev),
                              params=params, num_primes=num_primes),
            lc.DecompressionKey(bsk_scan=from_u32(dec_bsk_scan_u32, dev),
                                br_base_log=params.br_base_log,
                                br_level=params.br_level,
                                num_primes=dec_num_primes))


def compressed_list_from_arrays(params, storage_u32, count: int,
                                message_modulus: int, carry_modulus: int,
                                device=None) -> lc.CompressedCiphertextList:
    """A CompressedCiphertextList from ``tfhe_tpu``'s ``storage``
    u32[n_glwe, R_c, N_c]."""
    return lc.CompressedCiphertextList(
        storage=from_u32(storage_u32, resolve_device(device)), count=count,
        message_modulus=message_modulus, carry_modulus=carry_modulus,
        params=params)


def compressed_server_key_from_arrays(params_name: str, bsk_bodies_u64,
                                      ksk_bodies_u64, mask_seed: int,
                                      bsk_mask_start: int,
                                      ksk_mask_start: int, max_degree: int,
                                      device=None) -> CompressedServerKey:
    """A CompressedServerKey from ``tfhe_tpu``'s bodies (BSK u64[n, l,
    k+1, N], KSK u64[n_big, l_ks]) and mask-stream coordinates."""
    dev = resolve_device(device)
    return CompressedServerKey(
        params=PARAMS_BY_NAME[params_name],
        bsk_bodies=from_u64(bsk_bodies_u64, dev),
        ksk_bodies=from_u64(ksk_bodies_u64, dev), mask_seed=mask_seed,
        bsk_mask_start=bsk_mask_start, ksk_mask_start=ksk_mask_start,
        max_degree=max_degree)


def wopbs_key_from_arrays(server_key: ServerKey, pfpksk_u64,
                          wopbs_bsk_hat_u32, wopbs_pbs_base_log: int,
                          wopbs_pbs_levels: int, cbs_base_log: int,
                          cbs_levels: int, pf_base_log: int,
                          pf_levels: int) -> WopbsKey:
    """A WopbsKey beside ``server_key`` from ``tfhe_tpu``'s packing keys
    u64[k+1, n_in+1, l_pf, k+1, N] and its bootstrap key's residues and
    Shoup duals u32[2, P, n, l, R, R, N], on the server key's device."""
    dev = server_key.device
    bsk = from_u32(wopbs_bsk_hat_u32, dev)
    return WopbsKey(
        server_key=server_key, pfpksk=from_u64(pfpksk_u64, dev),
        wopbs_bsk_hat=bsk, wopbs_pbs_base_log=wopbs_pbs_base_log,
        wopbs_pbs_levels=wopbs_pbs_levels, wopbs_num_primes=bsk.shape[1],
        cbs_base_log=cbs_base_log, cbs_levels=cbs_levels,
        pf_base_log=pf_base_log, pf_levels=pf_levels)


# -- noise squashing ----------------------------------------------------------
# The squashing parameter sets are the caller's objects, as above.

def noise_squashing_private_key_from_arrays(params, glwe_sk_bits,
                                            device=None
                                            ) -> ns.NoiseSquashingPrivateKey:
    """A NoiseSquashingPrivateKey from its u128 GLWE key bits u64[k, N]."""
    return ns.NoiseSquashingPrivateKey(
        glwe_sk=GlweSecretKey128(from_u64(glwe_sk_bits,
                                          resolve_device(device))),
        params=params)


def noise_squashing_key_from_arrays(params, bsk_res_u32,
                                    device=None) -> ns.NoiseSquashingKey:
    """A NoiseSquashingKey from ``tfhe_tpu``'s ``bsk_res`` u32[P, n, l, R,
    R, N]."""
    res = from_u32(bsk_res_u32, resolve_device(device))
    return ns.NoiseSquashingKey(
        bsk_res=res, base_log=params.decomp_base_log,
        levels=params.decomp_level_count, num_primes=res.shape[0],
        params=params)


def squashed_ciphertext_from_arrays(hi_u64, lo_u64, degree: int,
                                    message_modulus: int, carry_modulus: int,
                                    device=None) -> ns.SquashedNoiseCiphertext:
    """A SquashedNoiseCiphertext from ``tfhe_tpu``'s (hi, lo) u64[...,
    kN+1]."""
    dev = resolve_device(device)
    return ns.SquashedNoiseCiphertext(
        hi=from_u64(hi_u64, dev), lo=from_u64(lo_u64, dev),
        degree=int(degree), message_modulus=message_modulus,
        carry_modulus=carry_modulus)


def squash_compression_keys_from_arrays(params, comp_glwe_sk_bits,
                                        pksk_hat_u32, in_dim: int,
                                        device=None) -> tuple:
    """(NoiseSquashingCompressionPrivateKey, NoiseSquashingCompressionKey)
    from ``tfhe_tpu``'s: the packed domain's GLWE key bits u64[k_c, N_c]
    and the packing key's residues u32[P, n_in, l, R_c, N_c]."""
    dev = resolve_device(device)
    pksk = from_u32(pksk_hat_u32, dev)
    return (nsc.NoiseSquashingCompressionPrivateKey(
                glwe_sk=GlweSecretKey128(from_u64(comp_glwe_sk_bits, dev)),
                params=params),
            nsc.NoiseSquashingCompressionKey(
                pksk_hat=pksk, params=params, num_primes=pksk.shape[0],
                in_dim=in_dim))


def compressed_squashed_list_from_arrays(
        params, glwe_hi_u64, glwe_lo_u64, count: int, message_modulus: int,
        carry_modulus: int, degrees=None, device=None
) -> nsc.CompressedSquashedNoiseCiphertextList:
    """A CompressedSquashedNoiseCiphertextList from ``tfhe_tpu``'s packed
    GLWEs (hi, lo) u64[n_glwe, R_c, N_c]."""
    dev = resolve_device(device)
    return nsc.CompressedSquashedNoiseCiphertextList(
        glwe_hi=from_u64(glwe_hi_u64, dev), glwe_lo=from_u64(glwe_lo_u64, dev),
        count=count, message_modulus=message_modulus,
        carry_modulus=carry_modulus, params=params,
        degrees=None if degrees is None else list(degrees))


def ntt64_bootstrap_key_from_arrays(bsk_u64, device=None):
    """The prime-modulus NTT64 PBS key from ``tfhe_tpu``'s u64[n, l, R, R,
    N] (``bsk_hat`` of ``ntt64_pbs.bootstrap_key_to_ntt64``, or the
    standard-domain key): canonical values mod q as int64, the layout K6
    reads."""
    return from_u64(bsk_u64, resolve_device(device)).contiguous()


def ntt64_ciphertexts_from_arrays(cts_u64, device=None):
    """Mod-q LWE (u64[B, n+1]) or GLWE (u64[B, R, N]) ciphertexts of the
    NTT64 PBS from ``tfhe_tpu``'s, as int64."""
    return from_u64(cts_u64, resolve_device(device))


def zk_from_envelope(blob: bytes):
    """A ZK CRS or proof (``PkeV2Crs`` / ``PkeV2Proof``) from its envelope
    bytes, as ``tfhe_tpu.utils.serialization`` writes them (host
    objects)."""
    from .utils import serialization as ser

    return ser.deserialize(blob, device="cpu")


def _points(cls, points):
    """Points of an object in memory, carried by their bytes (checked on
    the curve; their subgroup was checked where they were made or
    loaded)."""
    return [cls.from_bytes(p.to_bytes(), check_subgroup=False)
            for p in points]


def zk_crs_from_fields(crs):
    """The port's ``PkeV2Crs`` (or v1 ``PkeCrs``) from a ``tfhe_tpu`` CRS:
    its int fields copied, its points carried by their bytes."""
    from .zk.curve import G1, G2
    from .zk.pke import PkeCrs
    from .zk.pke_v2 import PkeV2Crs

    if hasattr(crs, "b_inf"):
        cls, names = PkeV2Crs, ("d", "k", "b_inf", "q", "t", "pad_bits",
                                "bound_type", "n", "big_d",
                                "b_bound_squared", "m_bound", "sid", "ds")
    else:
        cls, names = PkeCrs, ("d", "k", "b", "q", "t", "pad_bits", "n",
                              "big_d", "b_r", "sid", "ds")
    return cls(g_list=_points(G1, crs.g_list),
               g_hat_list=_points(G2, crs.g_hat_list),
               **{f: getattr(crs, f) for f in names})


def zk_proof_from_fields(proof):
    """The port's ``PkeV2Proof`` (or v1 ``PkeProof``) from a ``tfhe_tpu``
    proof, point by point through their bytes."""
    from .utils.serialization import PROOF_FIELDS
    from .zk.curve import G1, G2
    from .zk.pke import PkeProof
    from .zk.pke_v2 import PkeV2Proof

    if hasattr(proof, "C_hat_e"):
        cls, names = PkeV2Proof, PROOF_FIELDS
    else:
        cls, names = PkeProof, ("c_hat", "c_y", "pi")
    pts = {f: getattr(proof, f) for f in names}
    return cls(**{f: _points(G2 if type(p).__name__ == "G2" else G1, [p])[0]
                  for f, p in pts.items()})
