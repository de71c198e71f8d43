"""Shortint server key: LUTs, many-LUT, the atomic patterns (KS -> PBS,
KS32 with or without the drift technique, PBS -> KS) on the v6/v6b BNF2
path, the v5 Goldilocks path, the exact CRT path and the multi-bit PBS,
and the leveled and bivariate ops.

Torch counterpart of ``tfhe_tpu/shortint/server_key.py`` (reference
``tfhe/src/shortint/server_key/mod.rs``: generate_lookup_table:805,
apply_lookup_table:935; ``atomic_pattern/standard.rs:155``,
``atomic_pattern/ks32.rs``). The key holds device tensors: the KSK
(canonical and int8-limb form), the bootstrap key of the resolved transform
variant (BNF2 for v6/v6b, the Goldilocks key for v5, the P-prime NTT key in
scan layout for crt; a multi-bit set's key of GGSWs of subset products,
whatever the variant), and the drift technique's encryptions of zero.
"""

from __future__ import annotations

import math
import os
from dataclasses import dataclass
from typing import Callable, Optional

import numpy as np
import torch

from .._device import resolve_device
from .._torus import from_u32, from_u64, u64_const
from ..core import algorithms as algo
from ..core import noise_formulas as nf
from ..core.entities import LweBootstrapKey
from ..ops import bnf2 as b2
from ..ops import goldilocks as gl
from ..ops import ntt as ntt_mod
from ..ops import pbs_kernel as pk
from ..ops import server as server_ops
from ..utils import fork_budgets, trace
from ..utils.encoding import ShortintEncoding
from ..utils.params import (ClassicPBSParameters, EncryptionKeyChoice,
                            ModulusSwitchType)
from .ciphertext import (NOMINAL_NOISE, LookupTable, ManyLookupTable,
                         ShortintCiphertext)
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
    every value other than v5, v6 and v6b selects crt, and so does a
    multi-bit ``params`` or a shape outside the variant's kernel envelope
    (``bnf2.eligible``, ``goldilocks.eligible``); with ``params``,
    approximate variants must also pass :func:`variant_noise_margin_ok`
    (v6b degrades to v6, then to crt; v5 to crt)."""
    v = os.environ.get("TFHE_NTT_VARIANT", _DEFAULT_VARIANT)
    if grouping_of(params):
        return "crt"
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


def grouping_of(p) -> int:
    """The grouping factor g of a multi-bit parameter set, 0 for a classic
    one (``MultiBitPBSParameters``, or any set carrying a grouping)."""
    return getattr(p, "grouping_factor", 0) or 0


def check_supported(p, device=None) -> None:
    """Raise ValueError for a parameter set no server key can be built
    for: a multi-bit set whose LWE dimension the grouping does not divide
    (every set of the universe passes, multi-bit ones included), or, on a
    CUDA ``device``, before any key is drawn, a set whose exact CRT steps
    no kernel holds: a multi-bit set outside ``pbs_kernel.
    multi_bit_refusal`` (K5a with K5b or K7), a classic one outside
    ``pbs_kernel.crt_refusal`` (K3 or K7: the CRT key is the crt variant's
    and, under v6/v6b/v5, many-LUT's and the OPRF's). The universe's 20
    classic and 8 multi-bit sets at N = 65536 are refused (ROADMAP R10).
    No key can be drawn for them on the CPU either, here or in
    ``tfhe_tpu``: the CRT primes have no negacyclic transform at N =
    65536 (0x3F5D0001 has 2-adicity 16), and keygen raises as
    ``tfhe_tpu``'s does. Its 23 sets with base_log * levels >= 32 at N <=
    32768 run on the kernels' 64-bit decomposer; the 13 of them at N =
    32768 with 4 to 6 levels on K7's split with its levels streamed."""
    g = grouping_of(p)
    if g and p.lwe_dimension % g:
        raise ValueError(f"{p.name}: lwe_dimension {p.lwe_dimension} is not "
                         f"divisible by the grouping {g}")
    if device is None or torch.device(device).type != "cuda":
        return
    if g:
        why = pk.multi_bit_refusal(num_primes_for(p), g, p.glwe_size,
                                   p.pbs_level, p.pbs_base_log,
                                   p.polynomial_size)
    else:
        why = pk.crt_refusal(num_primes_for(p), p.glwe_size, p.pbs_level,
                             p.pbs_base_log, p.polynomial_size)
    if why:
        if p.polynomial_size == 65536:
            why += ("; nor can a key be drawn on the CPU, here or in "
                    "tfhe_tpu: the CRT primes have no negacyclic transform "
                    "at N = 65536 (0x3F5D0001 has 2-adicity 16)")
        raise ValueError(f"{p.name} cannot run on the GPU: {why} (ROADMAP "
                         "R10)")


def is_ks32(p) -> bool:
    """The KS32 atomic pattern: post-keyswitch ciphertexts live on a u32
    modulus (``KeySwitch32PBSParameters``, ``atomic_pattern/ks32.rs``)."""
    mod = getattr(p, "post_keyswitch_ciphertext_modulus", None)
    return mod is not None and mod.bits == 32


def drift_params(p):
    """(r_sigma, bound, input_variance) of a parameter set that selects the
    drift-technique modulus-switch noise reduction, else None."""
    d = getattr(p, "modulus_switch_noise_reduction_params", None)
    if (p.modulus_switch_type
            == ModulusSwitchType.DRIFT_TECHNIQUE_NOISE_REDUCTION
            and d is not None):
        return d.ms_r_sigma_factor, d.ms_bound, d.ms_input_variance
    return None


def flavor_for(variant: str) -> Optional[b2.Bnf2Flavor]:
    """The BNF2 prime pair of a transform variant (None for v5 and crt)."""
    return {"v6b": b2.FAST28, "v6": b2.DEFAULT, "v5": None,
            "crt": None}[variant]


def num_primes_for(p) -> int:
    """Primes of the exact CRT transform for a PBS shape: enough for the
    external product's bound base_log + 64 + log2 N + log2(l (k+1)) bits,
    plus g log2 3 bits for a multi-bit set's combined GGSW (the sum over
    subsets of 2^|v| = 3^g) (JAX ``ServerKey._num_primes_for``; 4 at 2_2
    and at every multi-bit set of the universe, 3 for the boolean sets)."""
    bound = ntt_mod.polymul_bound_bits(
        p.pbs_base_log, p.polynomial_size,
        num_sums=p.pbs_level * p.glwe_size)
    return ntt_mod.min_primes_for_bound(bound + grouping_of(p) * 1.585)


def _ksk_i8(p, ksk: torch.Tensor) -> torch.Tensor:
    """The KSK's int8 limbs, computed on its device (4 a value under
    KS32)."""
    return server_ops.ksk_limbs(ksk, p.ks_base_log, u32=is_ks32(p))


def prepare_crt_key(bsk_std: torch.Tensor, p) -> torch.Tensor:
    """Standard-domain BSK int64[n, l, R, R, N] -> the exact CRT key in scan
    layout int32 (u32) [n, 2, P, l*R, R, N], P = :func:`num_primes_for`."""
    ntt_key = algo.bootstrap_key_to_ntt(
        LweBootstrapKey(bsk_std, p.pbs_base_log, p.pbs_level),
        num_primes_for(p))
    return pk.bsk_to_scan_layout(ntt_key.residues)


def _count(ct: ShortintCiphertext, pbs: bool) -> None:
    """The trace counters of one dispatch (``utils/trace.py``): a keyswitch,
    and with ``pbs`` a bootstrap, for each ciphertext of the batch, at the
    sites where ``tfhe_tpu`` counts them (``server_key.py:595-598``,
    ``:684-687``, ``:699-702``)."""
    n = math.prod(ct.ct.shape[:-1]) or 1
    if pbs:
        trace.add_pbs(n)
    trace.add_ks(n)


@dataclass
class ServerKey:
    params: ClassicPBSParameters
    #: int64[n_big, l_ks, n_small+1] (u32 values under KS32)
    ksk: torch.Tensor
    ksk_i8: torch.Tensor  # int8[n_big*l_ks, (n_small+1)*limbs], 8 or 4 limbs
    bsk_b: Optional[torch.Tensor]  # int32 (u32) [n_small, 2, 2, l*R, R, N]
    variant: str
    max_degree: int = 0
    #: the exact CRT key, int32 (u32) [n_small, 2, P, l*R, R, N]: the crt
    #: variant's bootstrap key; under v6/v6b the many-LUT and OPRF key,
    #: built at first use (:meth:`crt_key`) from ``bsk_std``
    bsk_scan: Optional[torch.Tensor] = None
    #: the v5 variant's key, int32 (u32) [n_small, 2 (hi, lo), l*R, R, G,
    #: 128] (``tfhe_tpu``'s ``bsk_scan_g`` layout), and the same key in
    #: K4's order, int64 [n_small, l*R, R, N] (prepared once)
    bsk_g: Optional[torch.Tensor] = None
    bsk_g_k: Optional[torch.Tensor] = None
    #: the standard-domain BSK int64[n, l, R, R, N], kept under v6/v6b/v5
    #: until :meth:`crt_key` turns it into ``bsk_scan`` (under v5 only the
    #: stored form reads it: 56.8 MB on the key's device at 2_2)
    bsk_std: Optional[torch.Tensor] = None
    #: drift-technique modulus switching: encryptions of zero under the
    #: small key, int64[Z, n_small+1] (u32 values under KS32)
    #: (``shortint/server_key/modulus_switch_noise_reduction.rs``)
    ms_zeros: Optional[torch.Tensor] = None
    #: a multi-bit set's key in K5's layout, int32 (u32) [n/g, 2, P,
    #: 2^g-1, l*R, R, N] (``pbs_kernel.multi_bit_key_layout``): the key of
    #: every PBS of the set, whatever the variant
    bsk_mb: Optional[torch.Tensor] = None

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
        """Primes of the bootstrap key's transform: P for crt and for a
        multi-bit key, 2 for v6 and v6b, 1 for v5 (the Goldilocks prime)."""
        if self.bsk_mb is not None:
            return self.bsk_mb.shape[2]
        if self.variant == "v5":
            return 1
        key = self.bsk_scan if self.variant == "crt" else self.bsk_b
        return key.shape[2]

    @property
    def ks32(self) -> bool:
        return is_ks32(self.params)

    @property
    def order(self) -> str:
        """'ks_pbs' for big-key ciphertexts, 'pbs_ks' for small-key ones
        (EncryptionKeyChoice, ``atomic_pattern/standard.rs:155-190``)."""
        return ("pbs_ks" if self.params.encryption_key_choice
                == EncryptionKeyChoice.SMALL else "ks_pbs")

    @property
    def drift(self):
        """(r_sigma, bound, input_variance) when the key runs the drift
        technique (its parameters ask for it and it carries the zeros)."""
        return drift_params(self.params) if self.ms_zeros is not None else None

    @property
    def _pbs_input_bits(self) -> int:
        """The torus the PBS switches from: 32 bits under KS32."""
        return 32 if self.ks32 else 64

    def crt_key(self) -> torch.Tensor:
        """The exact CRT key in scan layout, the key of many-LUT and the
        OPRF under v6/v6b (``tfhe_tpu`` keeps it beside every variant's key,
        ``server_key.py:423-442``). Built at first use from ``bsk_std``,
        which it then replaces, so the keygen of v6/v6b grows by
        ``bsk_std`` only; a v5 key keeps ``bsk_std`` for its stored form. A
        multi-bit key has none: its many-LUT and OPRF run on K5."""
        if self.bsk_mb is not None:
            raise ValueError("a multi-bit server key carries no classic CRT "
                             "key")
        if self.bsk_scan is None:
            self.bsk_scan = self.stored_bsk()
            self.bsk_std = None
        return self.bsk_scan

    def stored_bsk(self) -> torch.Tensor:
        """The bootstrap key as ``tfhe_tpu`` stores it (its serialization,
        its keycache, ``convert``): a classic key's exact CRT key in scan
        layout, int32 (u32) [n, 2, P, l*R, R, N], built into a temporary
        from ``bsk_std`` when the key holds none (the key is left as it
        was); a multi-bit key's residues and duals, int32 (u32) [2, P, n/g,
        2^g-1, l, R, R, N]."""
        if self.bsk_mb is not None:
            return pk.multi_bit_legacy_layout(self.bsk_mb,
                                              self.params.pbs_level)
        if self.bsk_scan is not None:
            return self.bsk_scan
        if self.bsk_std is None:
            raise ValueError("this server key carries neither the CRT key "
                             "nor the standard-domain BSK to build it from")
        return prepare_crt_key(self.bsk_std, self.params)

    # ------------------------------------------------------------------
    @classmethod
    def generate(cls, client_key: ClientKey,
                 reference_forks: bool = False) -> "ServerKey":
        """BSK (GGSW of each small-key bit under the GLWE key), then the KSK
        (big -> small; onto the u32 torus under KS32), then under the drift
        technique the encryptions of zero (small key, lwe noise, u32 under
        KS32), all drawn from the client key's keygen stream in the JAX
        package's order and computed on the client key's device.
        ``reference_forks=True`` draws the BSK with the reference's fork
        layout (``utils/fork_budgets.py``). The standard-domain BSK goes
        straight to the variant's form (the JAX package goes through the
        exact CRT form and back to BNF2, with equal bits). A multi-bit set
        draws the GGSWs of its subset products instead
        (``algorithms.gen_multi_bit_bootstrap_key``), whatever
        ``reference_forks`` says, as ``tfhe_tpu`` does."""
        p = client_key.params
        check_supported(p, client_key.device)
        g = grouping_of(p)
        variant = resolve_variant(p.polynomial_size, p.pbs_base_log,
                                  p.pbs_level, params=p)
        gen = client_key._keygen_gen
        if g:
            bsk = algo.gen_multi_bit_bootstrap_key(
                client_key.lwe_sk, client_key.glwe_sk, p.pbs_base_log,
                p.pbs_level, g, p.glwe_noise_distribution, gen)
        else:
            gen_bsk = (fork_budgets.gen_bootstrap_key_reference_forks
                       if reference_forks else algo.gen_bootstrap_key)
            bsk = gen_bsk(client_key.lwe_sk, client_key.glwe_sk,
                          p.pbs_base_log, p.pbs_level,
                          p.glwe_noise_distribution, gen)
        gen_ksk = (algo.gen_keyswitch_key32 if is_ks32(p)
                   else algo.gen_keyswitch_key)
        ksk = gen_ksk(client_key.big_lwe_sk, client_key.lwe_sk, p.ks_base_log,
                      p.ks_level, p.lwe_noise_distribution, gen)
        ms_zeros = None
        if drift_params(p) is not None:
            count = p.modulus_switch_noise_reduction_params \
                .modulus_switch_zeros_count
            enc = algo.lwe_encrypt32 if is_ks32(p) else algo.lwe_encrypt
            ms_zeros = enc(client_key.lwe_sk, np.zeros(count, np.uint64),
                           p.lwe_noise_distribution, gen)
        return cls.from_standard_keys(p, ksk.data, bsk.data, variant,
                                      ms_zeros=ms_zeros)

    @classmethod
    def from_standard_keys(cls, p, ksk: torch.Tensor, bsk_std: torch.Tensor,
                           variant: str,
                           ms_zeros: Optional[torch.Tensor] = None,
                           bsk_scan: Optional[torch.Tensor] = None,
                           ) -> "ServerKey":
        """Key preparation: the KSK's int8 limbs (4 under KS32) and the
        variant's transform of the standard-domain BSK int64[n, l, R, R, N]
        (a multi-bit set's [n/g, 2^g-1, l, R, R, N]: its exact CRT
        transform in K5's layout, whatever the variant). ``bsk_scan``, when
        given, is the exact CRT key (it must be the transform of
        ``bsk_std``)."""
        if grouping_of(p):
            return cls.from_multi_bit_residues(
                p, ksk, algo.bootstrap_key_to_ntt(
                    LweBootstrapKey(bsk_std, p.pbs_base_log, p.pbs_level),
                    num_primes_for(p)).residues, ms_zeros=ms_zeros)
        flavor = flavor_for(variant)
        bsk_g = (gl.bootstrap_key_to_goldilocks(bsk_std) if variant == "v5"
                 else None)
        if bsk_scan is None and variant == "crt":
            bsk_scan = prepare_crt_key(bsk_std, p)
        return cls(
            params=p,
            ksk=ksk,
            ksk_i8=_ksk_i8(p, ksk),
            bsk_b=(b2.bootstrap_key_to_bnf2(bsk_std, flavor) if flavor
                   else None),
            bsk_scan=bsk_scan,
            bsk_g=bsk_g,
            bsk_g_k=(pk.goldilocks_kernel_key(bsk_g) if bsk_g is not None
                     else None),
            bsk_std=(bsk_std if variant != "crt" and bsk_scan is None
                     else None),
            ms_zeros=ms_zeros,
            variant=variant,
            max_degree=p.message_modulus * p.carry_modulus - 1,
        )

    @classmethod
    def from_stored(cls, p, ksk_u64, bsk_scan_u32, num_primes: int,
                    device=None, ms_zeros_u64=None) -> "ServerKey":
        """A key from ``tfhe_tpu``'s stored arrays (its ``ServerKey``
        fields, what its serialization and keycache hold), on ``device``
        (the GPU when unset): the KSK u64[n_big, l_ks, n_small+1] (u32
        values under KS32), the CRT-domain bootstrap key in scan layout
        u32[n, 2 (residue/shoup), P, l*R, R, N] over the first
        ``num_primes`` PRIMES32, and under the drift technique the
        encryptions of zero u64[Z, n_small+1]. The standard-domain BSK is
        rebuilt exactly with the inverse NTT and the Garner reconstruction
        (as ``tfhe_tpu.shortint.server_key`` does before deriving its BNF2
        key), then prepared for the resolved variant (under v5, ``bsk_g``
        equals ``tfhe_tpu``'s ``ServerKey.bsk_scan_g``); the CRT key itself
        is kept as given. A multi-bit set's key arrives as ``tfhe_tpu``
        stores it, residues and duals u32[2, P, n/g, 2^g-1, l, R, R, N],
        and is laid out for K5."""
        dev = resolve_device(device)
        check_supported(p, dev)
        ksk = from_u64(ksk_u64, dev)
        ms_zeros = None if ms_zeros_u64 is None else from_u64(ms_zeros_u64,
                                                               dev)
        if grouping_of(p):
            res = np.asarray(bsk_scan_u32, dtype=np.uint32)
            if res.ndim != 8 or res.shape[:2] != (2, num_primes):
                raise ValueError(f"multi-bit key {res.shape} does not hold "
                                 f"{num_primes} primes of residues + Shoup "
                                 "duals")
            return cls.from_multi_bit_residues(p, ksk, from_u32(res, dev),
                                               ms_zeros=ms_zeros)
        variant = resolve_variant(p.polynomial_size, p.pbs_base_log,
                                  p.pbs_level, params=p)
        scan = np.asarray(bsk_scan_u32, dtype=np.uint32)
        if scan.ndim != 6 or scan.shape[1:3] != (2, num_primes):
            raise ValueError(f"scan layout {scan.shape} does not hold "
                             f"{num_primes} primes of residues + Shoup duals")
        nlwe, _, P, lR, R, N = scan.shape
        crt_key = from_u32(scan, dev)
        res = (crt_key[:, 0].to(torch.int64) & 0xFFFFFFFF).movedim(1, 0)
        plan = ntt_mod.get_plan(N, P)
        std = plan.reconstruct_u64(plan.inv(res)).reshape(
            nlwe, lR // R, R, R, N)
        return cls.from_standard_keys(p, ksk, std, variant,
                                      ms_zeros=ms_zeros, bsk_scan=crt_key)

    @classmethod
    def from_multi_bit_residues(cls, p, ksk: torch.Tensor,
                                residues: torch.Tensor,
                                ms_zeros: Optional[torch.Tensor] = None
                                ) -> "ServerKey":
        """A multi-bit key from the KSK and the bootstrap key's residues and
        Shoup duals as ``tfhe_tpu`` stores them, int32 (u32) [2, P, n/g,
        2^g-1, l, R, R, N], laid out for K5."""
        check_supported(p, ksk.device)
        return cls(
            params=p, ksk=ksk, ksk_i8=_ksk_i8(p, ksk), bsk_b=None,
            variant="crt", bsk_mb=pk.multi_bit_key_layout(residues),
            ms_zeros=ms_zeros,
            max_degree=p.message_modulus * p.carry_modulus - 1)

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
    def _accumulator(self, body: np.ndarray, box: int) -> torch.Tensor:
        """The trivial GLWE of a LUT body u64[N]: the first half-box
        negated and rotated out to center the boxes on the modulus-switch
        grid (engine/mod.rs:80-141)."""
        p = self.params
        half = box // 2
        with np.errstate(over="ignore"):
            body[:half] = np.uint64(0) - body[:half]
        body = np.roll(body, -half)
        acc = np.zeros((p.glwe_size, p.polynomial_size), dtype=np.uint64)
        acc[-1] = body
        return from_u64(acc, self.device)

    def generate_lookup_table(self, f: Callable[[int], int]) -> LookupTable:
        """One box of N/(mm*cm) slots per input value (engine/mod.rs:80)."""
        p = self.params
        mod_sup = p.message_modulus * p.carry_modulus
        box = p.polynomial_size // mod_sup
        enc = self.encoding
        fe = [int(f(int(x))) for x in range(mod_sup)]
        encoded = np.array([enc.encode(v) for v in fe], dtype=np.uint64)
        return LookupTable(acc=self._accumulator(np.repeat(encoded, box), box),
                           degree=max(fe))

    def generate_many_lookup_table(self, fns) -> ManyLookupTable:
        """Several functions packed in ONE accumulator as consecutive
        sub-LUTs: after a single blind rotation, the sample extraction at
        ``i * stride`` gives function i (engine/mod.rs:168
        fill_many_lut_accumulator, shortint/server_key/mod.rs:622-632). The
        input degree must be <= mod_sup/len(fns) - 1, so that the rotation
        stays inside sub-LUT 0."""
        p = self.params
        mod_sup = p.message_modulus * p.carry_modulus
        box = p.polynomial_size // mod_sup
        k = len(fns)
        if not 0 < k <= mod_sup // 2:
            raise ValueError(f"1 to {mod_sup // 2} functions, got {k}")
        max_degree = mod_sup // k - 1
        sub_size = (max_degree + 1) * box
        enc = self.encoding
        body = np.zeros(p.polynomial_size, dtype=np.uint64)
        degrees = []
        for i, f in enumerate(fns):
            vals = [int(f(v)) for v in range(max_degree + 1)]
            for v, val in enumerate(vals):
                lo = i * sub_size + v * box
                body[lo:lo + box] = enc.encode(val)
            degrees.append(max(vals))
        return ManyLookupTable(acc=self._accumulator(body, box),
                               degrees=degrees, stride=sub_size, count=k,
                               max_input_degree=max_degree)

    def generate_msg_lookup_table(self, f, modulus: Optional[int] = None
                                  ) -> LookupTable:
        m = modulus or self.params.message_modulus
        return self.generate_lookup_table(lambda x: f(x % m) % m)

    # ------------------------------------------------------------------
    # the atomic patterns
    # ------------------------------------------------------------------
    def ks_only(self, ct: torch.Tensor) -> torch.Tensor:
        """Keyswitch big -> small key (onto the u32 torus under KS32)."""
        p = self.params
        ks = (server_ops.keyswitch_mxu32 if self.ks32
              else server_ops.keyswitch_mxu)
        return ks(ct, self.ksk_i8, p.ks_base_log, p.ks_level)

    def pbs_only(self, ct_small: torch.Tensor,
                 lut_acc: torch.Tensor) -> torch.Tensor:
        """PBS small -> big key on the variant's kernels (a multi-bit key:
        the standard switch, K2 u64 and K5, whatever the variant, as
        ``tfhe_tpu``'s ``server_key.py:155-160``); under the drift
        technique the chosen encryption of zero is added first and the
        switch is the standard one (``tfhe_tpu``'s ``server_key.py:
        177-191``)."""
        p = self.params
        bits = self._pbs_input_bits
        centered = (p.modulus_switch_type
                    == ModulusSwitchType.CENTERED_MEAN_NOISE_REDUCTION)
        if self.drift is not None:
            r_sigma, bound, input_variance = self.drift
            ct_small = server_ops.improve_drift_ms(
                ct_small, self.ms_zeros, r_sigma, bound, input_variance,
                p.polynomial_size.bit_length(), torus_bits=bits)
        if self.flavor is not None:
            return server_ops.programmable_bootstrap_bnf2(
                ct_small, lut_acc, self.bsk_b, p.pbs_base_log, p.pbs_level,
                centered, flavor=self.flavor, input_torus_bits=bits)
        batch, rotated = self._rotate(ct_small, lut_acc, centered, bits)
        out = server_ops.sample_extract(rotated, 0)
        return out.reshape(batch + (out.shape[-1],))

    def _rotate(self, ct_small: torch.Tensor, lut: torch.Tensor,
                centered: bool, torus_bits: int) -> tuple:
        """Modulus switch and blind rotation on the key's exact kernels,
        (batch shape, rotated GLWE int64[B, R, N]): a multi-bit key's K2 u64
        -> K5 (the standard switch whatever ``centered`` says, as
        ``tfhe_tpu``'s ``server_key.py:155-160``), the Goldilocks key's K2
        u64 -> K4 under v5, else the CRT key's K2 u64 -> K3 (or K2 acc32 ->
        K3-acc32 under ``TFHE_V4_ACC=32``). The one place that picks the
        rotation of the PBS off the BNF2 path, of many-LUT and of the
        OPRF."""
        p = self.params
        multi_bit = self.bsk_mb is not None
        batch, ms_mask, ms_body, lut = server_ops._switch_and_flatten(
            ct_small, lut, p.polynomial_size, centered and not multi_bit,
            torus_bits)
        args = (lut, ms_mask, ms_body)
        if multi_bit:
            rotated = server_ops.multi_bit_rotation(
                *args, self.bsk_mb, p.pbs_base_log, p.pbs_level)
        elif self.variant == "v5":
            rotated = server_ops.goldilocks_rotation(
                *args, self.bsk_g, p.pbs_base_log, p.pbs_level,
                self.bsk_g_k)
        else:
            rotated = server_ops.crt_rotation(
                *args, self.crt_key(), p.pbs_base_log, p.pbs_level)
        return batch, rotated

    def ks_pbs(self, ct: torch.Tensor, lut_acc: torch.Tensor) -> torch.Tensor:
        """The atomic pattern on a tensor: KS -> PBS for big-key
        ciphertexts, PBS -> KS for small-key ones."""
        if self.order == "pbs_ks":
            return self.ks_only(self.pbs_only(ct, lut_acc))
        return self.pbs_only(self.ks_only(ct), lut_acc)

    def apply_lookup_table(self, ct: ShortintCiphertext,
                           lut: LookupTable) -> ShortintCiphertext:
        expect = "big" if self.order == "ks_pbs" else "small"
        if ct.under_key != expect:
            raise ValueError(f"{self.order} pattern expects {expect}-key "
                             f"input, got {ct.under_key}")
        _count(ct, pbs=True)
        out = self.ks_pbs(ct.ct.to(self.device), lut.acc)
        return ShortintCiphertext(
            ct=out,
            degree=lut.degree,
            noise_level=NOMINAL_NOISE,
            message_modulus=ct.message_modulus,
            carry_modulus=ct.carry_modulus,
            under_key=expect,
        )

    def apply_many_lookup_table(self, ct: ShortintCiphertext,
                                many: ManyLookupTable) -> list:
        """ONE keyswitch and blind rotation, then ``many.count`` sample
        extractions from the rotated GLWE. The rotation runs on the exact
        CRT key (K2 u64 -> K3, or K2 acc32 -> K3-acc32 under
        ``TFHE_V4_ACC=32``) under v6/v6b/crt, and on the Goldilocks key (K2
        u64 -> K4) under v5, as ``tfhe_tpu``'s ``server_key.py:578-668``;
        the switch is the centered or the standard one (never the drift
        technique's), from the u32 torus under KS32. A multi-bit key runs
        its rotation on K2 u64 -> K5 with the standard switch, then the
        extractions, as tfhe-rs does; ``tfhe_tpu`` raises there (ROADMAP
        standing note 11)."""
        if ct.under_key != "big":
            raise ValueError(f"many-LUT expects big-key input, got "
                             f"{ct.under_key}")
        if ct.degree > many.max_input_degree:
            raise ValueError(f"input degree {ct.degree} exceeds the "
                             f"many-LUT limit {many.max_input_degree}")
        centered = (self.params.modulus_switch_type
                    == ModulusSwitchType.CENTERED_MEAN_NOISE_REDUCTION)
        _count(ct, pbs=True)
        small = self.ks_only(ct.ct.to(self.device))
        batch, rotated = self._rotate(small, many.acc, centered,
                                      self._pbs_input_bits)
        rotated = rotated.reshape(batch + tuple(many.acc.shape))
        return [ShortintCiphertext(
            ct=server_ops.sample_extract(rotated, i * many.stride),
            degree=many.degrees[i], noise_level=NOMINAL_NOISE,
            message_modulus=ct.message_modulus,
            carry_modulus=ct.carry_modulus, under_key="big")
            for i in range(many.count)]

    def keyswitch(self, ct: ShortintCiphertext) -> ShortintCiphertext:
        _count(ct, pbs=False)
        return ct.with_ct(self.ks_only(ct.ct.to(self.device)))

    def message_extract(self, ct: ShortintCiphertext) -> ShortintCiphertext:
        """PBS with x -> x % message_modulus (clears carries)."""
        lut = self.generate_lookup_table(
            lambda x: x % self.params.message_modulus)
        return self.apply_lookup_table(ct, lut)

    def carry_extract(self, ct: ShortintCiphertext) -> ShortintCiphertext:
        lut = self.generate_lookup_table(
            lambda x: x // self.params.message_modulus)
        return self.apply_lookup_table(ct, lut)

    # ------------------------------------------------------------------
    # leveled operations: degree and noise bookkeeping per
    # shortint/ciphertext/common.rs
    # ------------------------------------------------------------------
    def _check_noise(self, level: int):
        if level > self.params.max_noise_level:
            raise ValueError(f"noise level {level} exceeds max "
                             f"{self.params.max_noise_level}")

    def unchecked_add(self, a: ShortintCiphertext,
                      b: ShortintCiphertext) -> ShortintCiphertext:
        return ShortintCiphertext(
            ct=a.ct + b.ct.to(a.ct.device),
            degree=a.degree + b.degree,
            noise_level=a.noise_level + b.noise_level,
            message_modulus=a.message_modulus,
            carry_modulus=a.carry_modulus,
            under_key=a.under_key,
        )

    def _add_to_body(self, ct: torch.Tensor, value: int) -> torch.Tensor:
        out = ct.clone()
        out[..., -1] += u64_const(value)
        return out

    def unchecked_scalar_add(self, a: ShortintCiphertext,
                             scalar: int) -> ShortintCiphertext:
        delta = self.encoding.delta()
        return a.with_ct(self._add_to_body(a.ct, scalar * delta),
                         degree=a.degree + scalar)

    def unchecked_scalar_mul(self, a: ShortintCiphertext,
                             scalar: int) -> ShortintCiphertext:
        return a.with_ct(a.ct * u64_const(scalar), degree=a.degree * scalar,
                         noise_level=a.noise_level * scalar)

    def unchecked_neg(self, a: ShortintCiphertext) -> ShortintCiphertext:
        """-ct plus the degree correction z * Delta, z the smallest
        multiple of message_modulus above the degree (server_key/neg.rs)."""
        mm = a.message_modulus
        z = math.ceil((a.degree + 1) / mm) * mm
        delta = self.encoding.delta()
        return a.with_ct(self._add_to_body(-a.ct, z * delta), degree=z - 1)

    def unchecked_sub(self, a: ShortintCiphertext,
                      b: ShortintCiphertext) -> ShortintCiphertext:
        return self.unchecked_add(a, self.unchecked_neg(b))

    # ------------------------------------------------------------------
    # PBS-based binary ops
    # ------------------------------------------------------------------
    def unchecked_apply_lookup_table_bivariate(
            self, a: ShortintCiphertext, b: ShortintCiphertext,
            f: Callable[[int, int], int]) -> ShortintCiphertext:
        """Pack lhs * factor + rhs, then one univariate PBS
        (shortint/server_key/bivariate_pbs.rs:26-45,141)."""
        factor = b.degree + 1
        packed = self.unchecked_add(self.unchecked_scalar_mul(a, factor), b)
        self._check_noise(packed.noise_level)
        mm = self.params.message_modulus
        lut = self.generate_lookup_table(
            lambda x: f((x // factor) % mm, x % factor))
        return self.apply_lookup_table(packed, lut)

    def add(self, a: ShortintCiphertext,
            b: ShortintCiphertext) -> ShortintCiphertext:
        """Default add (shortint/server_key/add.rs:85-101): message-extract
        dirty inputs, add, message-extract the sum (empty carry out)."""
        mm = self.params.message_modulus
        if a.degree >= mm:
            a = self.message_extract(a)
        if b.degree >= mm:
            b = self.message_extract(b)
        out = self.unchecked_add(a, b)
        self._check_noise(out.noise_level)
        return self.message_extract(out)

    def smart_add(self, a: ShortintCiphertext,
                  b: ShortintCiphertext) -> ShortintCiphertext:
        """Smart add (add.rs:303-325): clean the inputs only when the sum
        would overflow the degree or noise budget; carries are kept."""
        p = self.params
        budget = p.message_modulus * p.carry_modulus - 1
        if (a.degree + b.degree > budget
                or a.noise_level + b.noise_level > p.max_noise_level):
            if a.degree >= b.degree:
                a = self.message_extract(a)
            if a.degree + b.degree > budget:
                b = self.message_extract(b)
        out = self.unchecked_add(a, b)
        self._check_noise(out.noise_level)
        return out

    def mul(self, a: ShortintCiphertext,
            b: ShortintCiphertext) -> ShortintCiphertext:
        mm = self.params.message_modulus
        return self.unchecked_apply_lookup_table_bivariate(
            a, b, lambda x, y: (x * y) % mm)

