"""Shortint server key: LUTs and the KS -> PBS atomic pattern on the
v6/v6b BNF2 path, the v5 Goldilocks path and the exact CRT path.

Torch counterpart of the main-path subset of
``tfhe_tpu/shortint/server_key.py`` (reference
``tfhe/src/shortint/server_key/mod.rs``: generate_lookup_table:805,
apply_lookup_table:935; ``atomic_pattern/standard.rs:155``). The key holds
device tensors: the KSK (canonical and int8-limb form) and the bootstrap
key of the resolved transform variant (BNF2 for v6/v6b, the Goldilocks key
for v5, the P-prime NTT key in scan layout for crt).

What this slice does not carry raises ``NotImplementedError`` naming the
ROADMAP item; no other path is substituted.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Callable, Optional

import numpy as np
import torch

from .._roadmap import not_ported
from .._torus import from_u64, to_u64
from ..core import algorithms as algo
from ..core import noise_formulas as nf
from ..core.entities import LweBootstrapKey
from ..ops import bnf2 as b2
from ..ops import goldilocks as gl
from ..ops import ntt as ntt_mod
from ..ops import pbs_kernel as pk
from ..ops import server as server_ops
from ..utils.encoding import ShortintEncoding
from ..utils.params import (ClassicPBSParameters, EncryptionKeyChoice,
                            ModulusSwitchType)
from .ciphertext import NOMINAL_NOISE, LookupTable, ShortintCiphertext
from .client_key import ClientKey

#: default transform variant of the classic-PBS path, as in tfhe_tpu:
#: "v6b" = the 2-prime BNF kernel over the FAST28 pair, "v6" = the same
#: over the ~30-bit DEFAULT pair, "v5" = the single-prime Goldilocks
#: path, "crt" = the exact P-prime CRT path.
#: Override with TFHE_NTT_VARIANT.
_DEFAULT_VARIANT = "v6b"


def variant_noise_margin_ok(p, variant: str, margin: float = 0.05) -> bool:
    """Noise-budget gate of the approximate BNF variants (v6, v6b, v5):
    the variant's extra transform variance must be <= ``margin`` x the
    exact path's own blind-rotation variance at this parameter set. True
    for 'crt'."""
    if variant == "crt":
        return True
    q = 2.0 ** 64
    bsk_var_torus = p.glwe_noise_distribution.variance(q) / q ** 2
    exact = nf.blind_rotate_additive_variance_exact(
        p.lwe_dimension, p.glwe_dimension, p.polynomial_size,
        p.pbs_base_log, p.pbs_level, bsk_var_torus)
    mod = {"v6": float(b2.DEFAULT.qp), "v6b": float(b2.FAST28.qp),
           "v5": float(gl.P)}[variant]
    extra = nf.bnf_blind_rotate_extra_variance(
        p.lwe_dimension, p.glwe_dimension, p.polynomial_size,
        p.pbs_base_log, p.pbs_level,
        transform_modulus=mod,
        acc32=(variant in ("v6", "v6b") and server_ops.acc_mode() == "32"))
    return extra <= margin * exact


def resolve_variant(poly_size: int, pbs_base_log: int, pbs_levels: int,
                    params=None) -> str:
    """'v6b', 'v6', 'v5' or 'crt' for the given PBS shape, honoring
    TFHE_NTT_VARIANT as the JAX package does (``server_key.py:86-110``):
    every value other than v5, v6 and v6b selects crt, and so does a shape
    outside the variant's kernel envelope (``bnf2.eligible``,
    ``goldilocks.eligible``); with ``params``, approximate variants must
    also pass :func:`variant_noise_margin_ok` (v6b degrades to v6, then to
    crt; v5 to crt)."""
    v = os.environ.get("TFHE_NTT_VARIANT", _DEFAULT_VARIANT)
    if v in ("v6", "v6b") and b2.eligible(poly_size, pbs_base_log,
                                          pbs_levels):
        if params is None or variant_noise_margin_ok(params, v):
            return v
        if (v == "v6b" and params is not None
                and variant_noise_margin_ok(params, "v6")):
            return "v6"
    if (v == "v5" and gl.eligible(poly_size, pbs_base_log, pbs_levels)
            and (params is None or variant_noise_margin_ok(params, "v5"))):
        return "v5"
    return "crt"


def check_supported(p) -> None:
    """Raise NotImplementedError for a parameter set outside this slice
    (parameters are duck-typed: a multi-bit or KS32 set from elsewhere must
    not silently run the classic path)."""
    if getattr(p, "grouping_factor", 0):
        raise not_ported("multi-bit PBS", 8)
    mod = getattr(p, "post_keyswitch_ciphertext_modulus", None)
    if mod is not None and mod.bits == 32:
        raise not_ported("the KS32 atomic pattern (keyswitch_mxu32)", 5)
    if p.encryption_key_choice != EncryptionKeyChoice.BIG:
        raise not_ported("the PBS -> KS order (small-key ciphertexts)", 5)
    if p.modulus_switch_type == ModulusSwitchType.DRIFT_TECHNIQUE_NOISE_REDUCTION:
        raise not_ported("drift-technique modulus switching", 5)


def flavor_for(variant: str) -> Optional[b2.Bnf2Flavor]:
    """The BNF2 prime pair of a transform variant (None for v5 and crt)."""
    return {"v6b": b2.FAST28, "v6": b2.DEFAULT, "v5": None,
            "crt": None}[variant]


def num_primes_for(p) -> int:
    """Primes of the exact CRT transform for a PBS shape: enough for the
    external product's bound base_log + 64 + log2 N + log2(l (k+1)) bits
    (JAX ``ServerKey._num_primes_for``; 4 at 2_2, 3 for the boolean sets)."""
    bound = ntt_mod.polymul_bound_bits(
        p.pbs_base_log, p.polynomial_size,
        num_sums=p.pbs_level * p.glwe_size)
    return ntt_mod.min_primes_for_bound(bound)


def prepare_crt_key(bsk_std: torch.Tensor, p) -> torch.Tensor:
    """Standard-domain BSK int64[n, l, R, R, N] -> the exact CRT key in scan
    layout int32 (u32) [n, 2, P, l*R, R, N], P = :func:`num_primes_for`."""
    ntt_key = algo.bootstrap_key_to_ntt(
        LweBootstrapKey(bsk_std, p.pbs_base_log, p.pbs_level),
        num_primes_for(p))
    return pk.bsk_to_scan_layout(ntt_key.residues)


@dataclass
class ServerKey:
    params: ClassicPBSParameters
    ksk: torch.Tensor  # int64[n_big, l_ks, n_small+1]
    ksk_i8: torch.Tensor  # int8[n_big*l_ks, (n_small+1)*8]
    bsk_b: Optional[torch.Tensor]  # int32 (u32) [n_small, 2, 2, l*R, R, N]
    variant: str
    max_degree: int = 0
    #: the crt variant's key, int32 (u32) [n_small, 2, P, l*R, R, N]
    bsk_scan: Optional[torch.Tensor] = None
    #: the v5 variant's key, int32 (u32) [n_small, 2 (hi, lo), l*R, R, G,
    #: 128] (``tfhe_tpu``'s ``bsk_scan_g`` layout), and the same key in
    #: K4's order, int64 [n_small, l*R, R, N] (prepared once)
    bsk_g: Optional[torch.Tensor] = None
    bsk_g_k: Optional[torch.Tensor] = None

    @property
    def device(self) -> torch.device:
        return self.ksk.device

    @property
    def ntt_variant(self) -> str:
        """The transform variant the key was prepared for."""
        return self.variant

    @property
    def flavor(self) -> Optional[b2.Bnf2Flavor]:
        return flavor_for(self.variant)

    @property
    def num_primes(self) -> int:
        """Primes of the bootstrap key's transform: P for crt, 2 for v6 and
        v6b, 1 for v5 (the Goldilocks prime)."""
        if self.variant == "v5":
            return 1
        key = self.bsk_scan if self.variant == "crt" else self.bsk_b
        return key.shape[2]

    # ------------------------------------------------------------------
    @classmethod
    def generate(cls, client_key: ClientKey) -> "ServerKey":
        """BSK (GGSW of each small-key bit under the GLWE key) then KSK
        (big -> small), drawn from the client key's keygen stream in the
        JAX package's order; computed on the client key's device. The
        standard-domain BSK goes straight to the variant's form (the JAX
        package goes through the exact 4-prime form and back to BNF2, with
        equal bits)."""
        p = client_key.params
        check_supported(p)
        variant = resolve_variant(p.polynomial_size, p.pbs_base_log,
                                  p.pbs_level, params=p)
        gen = client_key._keygen_gen
        bsk = algo.gen_bootstrap_key(
            client_key.lwe_sk, client_key.glwe_sk, p.pbs_base_log,
            p.pbs_level, p.glwe_noise_distribution, gen)
        ksk = algo.gen_keyswitch_key(
            client_key.big_lwe_sk, client_key.lwe_sk, p.ks_base_log,
            p.ks_level, p.lwe_noise_distribution, gen)
        return cls.from_standard_keys(p, ksk.data, bsk.data, variant)

    @classmethod
    def from_standard_keys(cls, p: ClassicPBSParameters, ksk: torch.Tensor,
                           bsk_std: torch.Tensor,
                           variant: str) -> "ServerKey":
        """Key preparation: the KSK's int8 limbs and the variant's transform
        of the standard-domain BSK int64[n, l, R, R, N]."""
        ksk_i8 = server_ops.ksk_to_i8_limbs(to_u64(ksk), p.ks_base_log)
        flavor = flavor_for(variant)
        bsk_g = (gl.bootstrap_key_to_goldilocks(bsk_std) if variant == "v5"
                 else None)
        return cls(
            params=p,
            ksk=ksk,
            ksk_i8=torch.from_numpy(ksk_i8).to(ksk.device),
            bsk_b=(b2.bootstrap_key_to_bnf2(bsk_std, flavor) if flavor
                   else None),
            bsk_scan=prepare_crt_key(bsk_std, p) if variant == "crt" else None,
            bsk_g=bsk_g,
            bsk_g_k=(pk.goldilocks_kernel_key(bsk_g) if bsk_g is not None
                     else None),
            variant=variant,
            max_degree=p.message_modulus * p.carry_modulus - 1,
        )

    @property
    def encoding(self) -> ShortintEncoding:
        p = self.params
        return ShortintEncoding(
            ciphertext_modulus=p.ciphertext_modulus,
            message_modulus=p.message_modulus,
            carry_modulus=p.carry_modulus,
            padding_bit=True,
        )

    # ------------------------------------------------------------------
    # lookup tables
    # ------------------------------------------------------------------
    def generate_lookup_table(self, f: Callable[[int], int]) -> LookupTable:
        """Accumulator layout per engine/mod.rs:80-141: one box of
        N/(mm*cm) slots per input value, the first half-box negated and
        rotated out to center the boxes on the modulus-switch grid."""
        p = self.params
        N = p.polynomial_size
        mod_sup = p.message_modulus * p.carry_modulus
        box = N // mod_sup
        enc = self.encoding
        fe = [int(f(int(x))) for x in range(mod_sup)]
        encoded = np.array([enc.encode(v) for v in fe], dtype=np.uint64)
        body = np.repeat(encoded, box)
        half = box // 2
        with np.errstate(over="ignore"):
            body[:half] = np.uint64(0) - body[:half]
        body = np.roll(body, -half)
        acc = np.zeros((p.glwe_size, N), dtype=np.uint64)
        acc[-1] = body
        return LookupTable(acc=from_u64(acc, self.device), degree=max(fe))

    # ------------------------------------------------------------------
    # the atomic pattern
    # ------------------------------------------------------------------
    def _ks_pbs(self, ct: torch.Tensor, lut_acc: torch.Tensor) -> torch.Tensor:
        """Keyswitch (big -> small key) then PBS (small -> big key)."""
        p = self.params
        small = server_ops.keyswitch_mxu(ct, self.ksk_i8, p.ks_base_log,
                                         p.ks_level)
        centered = (p.modulus_switch_type
                    == ModulusSwitchType.CENTERED_MEAN_NOISE_REDUCTION)
        if self.variant == "crt":
            return server_ops.programmable_bootstrap_crt(
                small, lut_acc, self.bsk_scan, p.pbs_base_log, p.pbs_level,
                centered_ms=centered)
        if self.variant == "v5":
            return server_ops.programmable_bootstrap_goldilocks(
                small, lut_acc, self.bsk_g, p.pbs_base_log, p.pbs_level,
                centered_ms=centered, bsk_k=self.bsk_g_k)
        return server_ops.programmable_bootstrap_bnf2(
            small, lut_acc, self.bsk_b, p.pbs_base_log, p.pbs_level,
            centered_ms=centered, flavor=self.flavor)

    def apply_lookup_table(self, ct: ShortintCiphertext,
                           lut: LookupTable) -> ShortintCiphertext:
        if ct.under_key != "big":
            raise ValueError(f"ks_pbs pattern expects big-key input, got "
                             f"{ct.under_key}")
        out = self._ks_pbs(ct.ct.to(self.device), lut.acc)
        return ShortintCiphertext(
            ct=out,
            degree=lut.degree,
            noise_level=NOMINAL_NOISE,
            message_modulus=ct.message_modulus,
            carry_modulus=ct.carry_modulus,
            under_key="big",
        )

    def keyswitch(self, ct: ShortintCiphertext) -> ShortintCiphertext:
        p = self.params
        out = server_ops.keyswitch_mxu(ct.ct.to(self.device), self.ksk_i8,
                                       p.ks_base_log, p.ks_level)
        return ct.with_ct(out)

    def message_extract(self, ct: ShortintCiphertext) -> ShortintCiphertext:
        """PBS with x -> x % message_modulus (clears carries)."""
        lut = self.generate_lookup_table(
            lambda x: x % self.params.message_modulus)
        return self.apply_lookup_table(ct, lut)
