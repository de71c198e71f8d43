"""Boolean client/server keys and gates, in torch.

Torch counterpart of ``tfhe_tpu/boolean/keys.py``. Gate recipes (reference
boolean/engine/mod.rs:558-800, all wrapping mod 2^64):

    AND:  l + r + FALSE
    NAND: -(l + r) + TRUE
    NOR:  -(l + r) + FALSE
    OR:   l + r + TRUE
    XOR:  2 * (l + r + TRUE)
    XNOR: 2 * (-(l + r + TRUE))
    NOT:  -ct                          (no bootstrap)
    MUX:  PBS(c + t + FALSE) + PBS(-c + e + FALSE) + TRUE, then keyswitch

Each bootstrap is the sign bootstrap: a PBS with the standard modulus
switch and the constant-TRUE accumulator (bootstrapping.rs:64) on the exact
CRT path (``server.programmable_bootstrap_crt``: K2 u64 then K3; under
``TFHE_V4_ACC=32`` K2 acc32 then K3-acc32, the rounded accumulator of the
TPU kernel), small key -> big key, followed by the int8-GEMM keyswitch big -> small. ``mux`` runs
its two bootstraps as one batch (one launch of each kernel); the results
are the same bits as two separate calls.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from .._device import resolve_device
from .._torus import to_u64, u64_const
from ..core import algorithms as algo
from ..core.entities import GlweSecretKey, LweSecretKey
from ..ops import pbs_kernel as pk
from ..ops import server as server_ops
from ..shortint.server_key import num_primes_for, prepare_crt_key
from ..utils.csprng import (AesCtrGenerator, EncryptionRandomGenerator,
                            SecretRandomGenerator)
from ..utils.params import BOOLEAN_DEFAULT_PARAMETERS, BooleanParameters

# q/8 and -q/8 on the 2^64 torus (the reference uses u32; same fractions)
PLAINTEXT_TRUE = 1 << 61
PLAINTEXT_FALSE = u64_const(7 << 61)


@dataclass
class BooleanCiphertext:
    ct: torch.Tensor  # int64[..., n+1] under the small key


def _add_to_body(ct: torch.Tensor, value: int) -> torch.Tensor:
    """ct with ``value`` added to its body (a fresh tensor)."""
    out = ct.clone()
    out[..., -1] += value
    return out


@dataclass
class ClientKey:
    params: BooleanParameters
    glwe_sk: GlweSecretKey
    lwe_sk: LweSecretKey
    device: torch.device
    # None for a key carried in without its seed (it decrypts only); also
    # the server key's keygen stream, as in the JAX package
    _enc_gen: EncryptionRandomGenerator = None

    @classmethod
    def generate(cls, params: BooleanParameters = BOOLEAN_DEFAULT_PARAMETERS,
                 seed: int = 0, device=None) -> "ClientKey":
        """Deterministic keygen from a root seed, on ``device`` (the GPU
        when unset): the root AES stream yields the secret and encryption
        sub-seeds; the LWE key is drawn first, then the GLWE key (the
        reference boolean engine's order)."""
        dev = resolve_device(device)
        root = AesCtrGenerator(seed)
        s_seed, e_seed, n_seed = (int(x) for x in root.uniform_u64(3))
        sec = SecretRandomGenerator(s_seed)
        lwe_sk = algo.gen_lwe_secret_key(params.lwe_dimension, sec, dev)
        glwe_sk = algo.gen_glwe_secret_key(params.glwe_dimension,
                                           params.polynomial_size, sec, dev)
        return cls(params=params, glwe_sk=glwe_sk, lwe_sk=lwe_sk, device=dev,
                   _enc_gen=EncryptionRandomGenerator(e_seed, n_seed))

    def encrypt(self, values) -> BooleanCiphertext:
        """Encrypt booleans (a scalar or array-like) under the small key."""
        if self._enc_gen is None:
            raise ValueError("this client key carries no encryption seed")
        vals = np.atleast_1d(np.asarray(values, dtype=bool))
        pts = np.where(vals, np.uint64(PLAINTEXT_TRUE),
                       np.uint64(7 << 61)).astype(np.uint64)
        cts = algo.lwe_encrypt(self.lwe_sk, pts.reshape(-1),
                               self.params.lwe_noise_distribution,
                               self._enc_gen)
        return BooleanCiphertext(
            ct=cts.reshape(vals.shape + (self.params.lwe_dimension + 1,)))

    def decrypt(self, ct: BooleanCiphertext) -> np.ndarray:
        """The sign of the phase: near +q/8 is true, near -q/8 false."""
        raw = algo.lwe_decrypt(self.lwe_sk, ct.ct.to(self.device))
        return (raw > 0).cpu().numpy().reshape(tuple(ct.ct.shape[:-1]))


@dataclass
class ServerKey:
    params: BooleanParameters
    ksk: torch.Tensor  # int64[k*N, l_ks, n+1]
    ksk_i8: torch.Tensor  # int8[k*N*l_ks, (n+1)*8]
    bsk_scan: torch.Tensor  # int32 (u32) [n, 2, P, l*R, R, N]

    @property
    def device(self) -> torch.device:
        return self.ksk.device

    @property
    def num_primes(self) -> int:
        return self.bsk_scan.shape[2]

    @property
    def bsk_hat(self) -> torch.Tensor:
        """The key in the legacy layout [2, P, n, l, R, R, N] (a view)."""
        return pk.scan_to_legacy_layout(self.bsk_scan, self.params.pbs_level)

    @classmethod
    def generate(cls, ck: ClientKey) -> "ServerKey":
        """BSK then KSK (big -> small), both drawn from the client key's
        encryption stream, as in the JAX package; the BSK goes to the exact
        CRT form over :func:`num_primes_for` primes, in scan layout."""
        p = ck.params
        gen = ck._enc_gen
        bsk = algo.gen_bootstrap_key(ck.lwe_sk, ck.glwe_sk, p.pbs_base_log,
                                     p.pbs_level, p.glwe_noise_distribution,
                                     gen)
        ksk = algo.gen_keyswitch_key(ck.glwe_sk.as_lwe_secret_key(),
                                     ck.lwe_sk, p.ks_base_log, p.ks_level,
                                     p.lwe_noise_distribution, gen)
        return cls.from_keys(p, ksk.data, prepare_crt_key(bsk.data, p))

    @classmethod
    def from_keys(cls, p: BooleanParameters, ksk: torch.Tensor,
                  bsk_scan: torch.Tensor) -> "ServerKey":
        """A server key from the KSK int64[k*N, l_ks, n+1] and the CRT key
        in scan layout; checks the key's shape against ``p``."""
        R, N = p.glwe_size, p.polynomial_size
        want = (p.lwe_dimension, 2, num_primes_for(p), p.pbs_level * R, R, N)
        if tuple(bsk_scan.shape) != want:
            raise ValueError(f"bsk_scan shape {tuple(bsk_scan.shape)} != "
                             f"{want} for {p.name}")
        ksk_i8 = server_ops.ksk_to_i8_limbs(to_u64(ksk), p.ks_base_log)
        return cls(params=p, ksk=ksk,
                   ksk_i8=torch.from_numpy(ksk_i8).to(ksk.device),
                   bsk_scan=bsk_scan)

    # -- the bootstrap pipeline ------------------------------------------------
    def _true_lut(self) -> torch.Tensor:
        """The constant-TRUE accumulator int64[R, N] (shared by the batch)."""
        p = self.params
        lut = torch.zeros((p.glwe_size, p.polynomial_size), dtype=torch.int64,
                          device=self.device)
        lut[-1] = PLAINTEXT_TRUE
        return lut

    def _bootstrap(self, ct: torch.Tensor) -> torch.Tensor:
        """Sign bootstrap, small key -> big key."""
        p = self.params
        return server_ops.programmable_bootstrap_crt(
            ct.to(self.device), self._true_lut(), self.bsk_scan,
            p.pbs_base_log, p.pbs_level, centered_ms=False)

    def _keyswitch(self, big: torch.Tensor) -> torch.Tensor:
        p = self.params
        return server_ops.keyswitch_mxu(big, self.ksk_i8, p.ks_base_log,
                                        p.ks_level)

    def _gate(self, combo: torch.Tensor) -> BooleanCiphertext:
        return BooleanCiphertext(ct=self._keyswitch(self._bootstrap(combo)))

    # -- gates -----------------------------------------------------------------
    def and_(self, l: BooleanCiphertext,
             r: BooleanCiphertext) -> BooleanCiphertext:
        return self._gate(_add_to_body(l.ct + r.ct, PLAINTEXT_FALSE))

    def or_(self, l: BooleanCiphertext,
            r: BooleanCiphertext) -> BooleanCiphertext:
        return self._gate(_add_to_body(l.ct + r.ct, PLAINTEXT_TRUE))

    def nand(self, l: BooleanCiphertext,
             r: BooleanCiphertext) -> BooleanCiphertext:
        return self._gate(_add_to_body(-(l.ct + r.ct), PLAINTEXT_TRUE))

    def nor(self, l: BooleanCiphertext,
            r: BooleanCiphertext) -> BooleanCiphertext:
        return self._gate(_add_to_body(-(l.ct + r.ct), PLAINTEXT_FALSE))

    def xor(self, l: BooleanCiphertext,
            r: BooleanCiphertext) -> BooleanCiphertext:
        return self._gate(_add_to_body(l.ct + r.ct, PLAINTEXT_TRUE) * 2)

    def xnor(self, l: BooleanCiphertext,
             r: BooleanCiphertext) -> BooleanCiphertext:
        return self._gate(-_add_to_body(l.ct + r.ct, PLAINTEXT_TRUE) * 2)

    def not_(self, ct: BooleanCiphertext) -> BooleanCiphertext:
        return BooleanCiphertext(ct=-ct.ct)

    def mux(self, cond: BooleanCiphertext, then_ct: BooleanCiphertext,
            else_ct: BooleanCiphertext) -> BooleanCiphertext:
        in1 = _add_to_body(cond.ct + then_ct.ct, PLAINTEXT_FALSE)
        in2 = _add_to_body(-cond.ct + else_ct.ct, PLAINTEXT_FALSE)
        both = self._bootstrap(torch.stack(torch.broadcast_tensors(in1, in2)))
        return BooleanCiphertext(
            ct=self._keyswitch(_add_to_body(both[0] + both[1],
                                            PLAINTEXT_TRUE)))


def gen_keys(params: BooleanParameters = BOOLEAN_DEFAULT_PARAMETERS,
             seed: int = 0, device=None):
    """(ClientKey, ServerKey) from one seed."""
    ck = ClientKey.generate(params, seed, device=device)
    return ck, ServerKey.generate(ck)
