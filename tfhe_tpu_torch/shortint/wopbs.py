"""WoP-PBS (programmable bootstrapping without padding): bit extraction,
circuit bootstrapping, vertical packing.

Torch counterpart of ``tfhe_tpu/shortint/wopbs.py`` (reference
``shortint/wopbs/mod.rs`` (WopbsKey, wopbs:544,
new_wopbs_key_only_for_wopbs:255), ``core_crypto/fft_impl/fft64/crypto/
wop_pbs/mod.rs`` (extract_bits:61, circuit_bootstrap_boolean:238,
vertical_packing:771) and the private functional packing keyswitch
(``lwe_private_functional_packing_keyswitch*.rs``, ``lwe_wopbs.rs``)).
LUTs are evaluated over the whole message + carry space with exact,
GGSW-selected lookups.

The WoP-PBS key's own bootstrap key is deeper than the compute key's
(base log 4, 8 levels): its PBS runs, at every size, as the port's torch
CRT PBS (``ops/server.py::programmable_bootstrap``) on the tensors' device,
as ``tfhe_tpu`` runs it in XLA; K3 cannot hold a step of that depth at
N = 2048 in one block's shared memory. The circuit bootstraps of all bits
and levels share one batched PBS (each its own accumulator), which gives
the bits of ``tfhe_tpu``'s one-at-a-time loop. The packing keyswitch's sum
and the CMUX products are exact mod 2^64 (elementwise int64) or mod p.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

import numpy as np
import torch

from .._torus import from_u64, u64_const
from ..core import algorithms as algo
from ..core.entities import LweBootstrapKey
from ..ops import ntt as ntt_mod
from ..ops import server as server_ops
from ..ops.decomp import decompose
from ..ops.polynomial import monomial_div
from ..utils.params import DynamicDistribution
from .ciphertext import NOMINAL_NOISE, ShortintCiphertext
from .client_key import ClientKey
from .server_key import ServerKey


def gen_cbs_pfpksk_list(big_lwe_sk, glwe_sk, base_log: int, levels: int,
                        noise: DynamicDistribution, gen) -> torch.Tensor:
    """int64[k+1, n_in+1, l, k+1, N]: key r encrypts, for input position p
    (the body position acts as key bit -1) and level j, the polynomial
    poly_r * (-keybit_p) << (64 - base_log * level), poly_r = s_r for r < k
    and [-1, 0, ...] for r = k (lwe_wopbs.rs:125-154). The draws are
    ``tfhe_tpu``'s: one GLWE encryption of the l levels per (r, p), in
    that order; all masks are one draw (a uniform stream splits anywhere),
    the noise is drawn call by call (the gaussian sampler's rejections
    redraw within a call), and the key products run once for all rows."""
    k, N = glwe_sk.bits.shape
    dev = glwe_sk.bits.device
    last = torch.zeros((1, N), dtype=torch.int64, device=dev)
    last[0, 0] = -1
    polys = torch.cat([glwe_sk.bits, last])  # [k+1, N]
    key_bits = torch.cat([big_lwe_sk.bits.to(dev),
                          torch.tensor([-1], dtype=torch.int64, device=dev)])
    shifts = torch.tensor([64 - base_log * (levels - j)
                           for j in range(levels)], device=dev)
    factor = (-key_bits)[:, None] << shifts  # [n_in+1, l]
    msgs = polys[:, None, None, :] * factor[None, :, :, None]
    M = msgs[..., 0].numel()
    masks = from_u64(gen.mask.uniform_u64(M * k * N).reshape(M, k, N), dev)
    noises = np.concatenate([gen.sample_noise(noise, levels * N)
                             for _ in range(M // levels)])
    body = (algo._binary_polymul_batch(glwe_sk.bits, masks)
            + msgs.reshape(M, N) + from_u64(noises.reshape(M, N), dev))
    rows = torch.cat([masks, body[:, None]], dim=1)
    return rows.reshape(k + 1, key_bits.shape[0], levels, k + 1, N)


def pfpks_apply(pfpksk_r: torch.Tensor, lwe: torch.Tensor, base_log: int,
                levels: int) -> torch.Tensor:
    """LWE -> GLWE with the private function in the key: out = -sum_p sum_j
    d_j(c_p) * K[p, j] mod 2^64 (lwe_private_functional_packing_keyswitch.rs
    :62-88), elementwise int64 (no int64 GEMM on the GPU), one LWE at a
    time. ``pfpksk_r``: int64[n+1, l, R, N]; ``lwe``: int64[..., n+1] ->
    int64[..., R, N]."""
    d = decompose(lwe.reshape(-1, lwe.shape[-1]), base_log, levels)
    outs = [-(dd[:, :, None, None] * pfpksk_r).sum(dim=(0, 1)) for dd in d]
    return torch.stack(outs).reshape(lwe.shape[:-1] + pfpksk_r.shape[-2:])


@dataclass
class WopbsKey:
    """WoP-PBS key beside the compute keyset (the reference's
    new_wopbs_key_only_for_wopbs:255 configuration: the compute KSK, the
    CBS packing keys and a deeper bootstrap key of its own)."""

    server_key: ServerKey
    pfpksk: torch.Tensor  # int64[k+1, n_in+1, l_pf, k+1, N]
    wopbs_bsk_hat: torch.Tensor  # int32 (u32) [2, P, n, l, R, R, N]
    wopbs_pbs_base_log: int
    wopbs_pbs_levels: int
    wopbs_num_primes: int
    cbs_base_log: int
    cbs_levels: int
    pf_base_log: int
    pf_levels: int

    @classmethod
    def generate(cls, client_key: ClientKey, server_key: ServerKey,
                 cbs_base_log: int = 6, cbs_levels: int = 4,
                 pf_base_log: int = 8, pf_levels: int = 5,
                 wopbs_pbs_base_log: int = 4,
                 wopbs_pbs_levels: int = 8) -> "WopbsKey":
        """The packing keys, then the bootstrap key, from the client key's
        keygen stream on its device. Circuit bootstrapping needs the PBS
        output accurate to the smallest GGSW factor
        2^(64 - cbs_base_log * cbs_levels), hence the deeper key."""
        p = client_key.params
        gen = client_key._keygen_gen
        pfpksk = gen_cbs_pfpksk_list(
            client_key.big_lwe_sk, client_key.glwe_sk, pf_base_log,
            pf_levels, p.glwe_noise_distribution, gen)
        bsk = algo.gen_bootstrap_key(
            client_key.lwe_sk, client_key.glwe_sk, wopbs_pbs_base_log,
            wopbs_pbs_levels, p.glwe_noise_distribution, gen)
        num_primes = ntt_mod.min_primes_for_bound(ntt_mod.polymul_bound_bits(
            wopbs_pbs_base_log, p.polynomial_size,
            num_sums=wopbs_pbs_levels * p.glwe_size))
        return cls(
            server_key=server_key, pfpksk=pfpksk,
            wopbs_bsk_hat=algo.bootstrap_key_to_ntt(bsk, num_primes).residues,
            wopbs_pbs_base_log=wopbs_pbs_base_log,
            wopbs_pbs_levels=wopbs_pbs_levels, wopbs_num_primes=num_primes,
            cbs_base_log=cbs_base_log, cbs_levels=cbs_levels,
            pf_base_log=pf_base_log, pf_levels=pf_levels)

    @property
    def device(self) -> torch.device:
        return self.pfpksk.device

    def _pbs_with_acc(self, lwe_small: torch.Tensor,
                      acc_body_consts) -> torch.Tensor:
        """Classic PBS of LWEs int64[B, n+1] against trivial accumulators
        whose body is one constant each (standard modulus switch), on the
        WoP-PBS bootstrap key: int64[B, k*N + 1]."""
        p = self.server_key.params
        N, R = p.polynomial_size, p.glwe_size
        consts = torch.tensor([u64_const(c) for c in acc_body_consts],
                              dtype=torch.int64, device=self.device)
        acc = torch.zeros((consts.shape[0], R, N), dtype=torch.int64,
                          device=self.device)
        acc[:, -1, :] = consts[:, None]
        return server_ops.programmable_bootstrap(
            lwe_small, acc, self.wopbs_bsk_hat, self.wopbs_pbs_base_log,
            self.wopbs_pbs_levels,
            ntt_mod.get_plan(N, self.wopbs_num_primes), centered_ms=False)

    def extract_bits(self, ct: ShortintCiphertext, delta_log: int,
                     nbits: int) -> list:
        """MSB-first LWEs under the small key, bit i at 2^63
        (wop_pbs/mod.rs:61-220)."""
        sk = self.server_key
        buf = ct.ct.reshape(-1).to(self.device)
        outs = [None] * nbits
        for bit_idx in range(nbits):
            shifted = buf << (64 - delta_log - bit_idx - 1)
            ksed = sk.ks_only(shifted[None])[0]
            outs[nbits - 1 - bit_idx] = ksed
            if bit_idx == nbits - 1:
                break
            ksed = ksed.clone()
            ksed[-1] += 1 << 62
            half = 1 << (delta_log - 1 + bit_idx)
            pbs_out = self._pbs_with_acc(ksed[None], [-half])[0]
            pbs_out[-1] += half
            buf = buf - pbs_out
        return outs

    def circuit_bootstrap(self, lwe_bit_small: torch.Tensor) -> torch.Tensor:
        """LWE(bit at 2^63) -> GGSW(bit) under the GLWE key
        (wop_pbs/mod.rs:238-340): a PBS per CBS level, then a private
        functional packing keyswitch per GLWE row. ``lwe_bit_small``:
        int64[..., n+1] -> int64[..., cbs_levels, R, R, N]; all bits and
        levels go through one batched PBS."""
        k = self.server_key.params.glwe_dimension
        R, L = k + 1, self.cbs_levels
        lwes = lwe_bit_small.reshape(-1, lwe_bit_small.shape[-1])
        shifted = lwes.clone()
        shifted[:, -1] += 1 << 62  # center the negacyclic error
        alphas = [1 << (63 - self.cbs_base_log * lvl)
                  for lvl in range(1, L + 1)]
        ins = shifted.repeat_interleave(L, dim=0)
        out = self._pbs_with_acc(ins, [-a for a in alphas] * lwes.shape[0])
        out[:, -1] += torch.tensor([u64_const(a) for a in alphas] * lwes.shape[0],
                                   dtype=torch.int64, device=self.device)
        # GGSW slot j holds level L - j (decompose order: the smallest
        # summand first): reverse the levels
        out = out.reshape(-1, L, out.shape[-1]).flip(1)
        rows = [pfpks_apply(self.pfpksk[r], out, self.pf_base_log,
                            self.pf_levels) for r in range(R)]
        ggsw = torch.stack(rows, dim=2)  # [B, L, R, R, N]
        return ggsw.reshape(lwe_bit_small.shape[:-1] + ggsw.shape[1:])

    def generate_lut(self, ct: ShortintCiphertext,
                     f: Callable[[int], int]) -> torch.Tensor:
        """LUT over the whole message + carry space at the padded Delta
        (wopbs/mod.rs:373): int64[n_polys, N]."""
        p = self.server_key.params
        mod_sup = p.message_modulus * p.carry_modulus
        delta = (1 << 63) // mod_sup
        N = p.polynomial_size
        nbits = mod_sup.bit_length() - 1
        lut = np.zeros((max(1, (1 << nbits) // N), N), dtype=np.uint64)
        for v in range(1 << nbits):
            lut[v // N, v % N] = np.uint64((f(v % mod_sup) % mod_sup) * delta)
        return torch.from_numpy(lut.view(np.int64)).to(self.device)

    def vertical_packing(self, lut: torch.Tensor, ggsw_list) -> torch.Tensor:
        """CMUX tree over the most significant GGSWs, blind rotation over
        the rest, sample extraction (wop_pbs/mod.rs:771-825):
        int64[k*N + 1]."""
        p = self.server_key.params
        N, R = p.polynomial_size, p.glwe_size
        nbits = len(ggsw_list)
        n_polys = lut.shape[0]
        log_polys = max(0, n_polys.bit_length() - 1)
        n_tree = log_polys if log_polys <= nbits else 0
        plan = ntt_mod.get_plan(N, ntt_mod.min_primes_for_bound(
            ntt_mod.polymul_bound_bits(self.cbs_base_log, N,
                                       num_sums=self.cbs_levels * R)))
        def cmux(ggsw, c0, c1):
            """ct1 when the GGSW (its transform, as a bootstrap key's row)
            encrypts 1, else ct0."""
            g = algo.bootstrap_key_to_ntt(LweBootstrapKey(
                ggsw, self.cbs_base_log, self.cbs_levels),
                plan.num_primes).residues
            return server_ops.cmux_ntt(g, c0, c1, self.cbs_base_log,
                                       self.cbs_levels, plan)

        layers = [torch.cat([torch.zeros((R - 1, N), dtype=torch.int64,
                                         device=lut.device), lut[i][None]])
                  for i in range(n_polys)]
        # the tree consumes its least significant bit first
        for t in range(n_tree):
            g = ggsw_list[n_tree - 1 - t]
            layers = [cmux(g, layers[i], layers[i + 1])
                      for i in range(0, len(layers), 2)]
        acc = layers[0]
        degree = 1
        for g in reversed(ggsw_list[n_tree:]):
            acc = cmux(g, acc, monomial_div(acc, degree))
            degree <<= 1
        return server_ops.sample_extract(acc, 0)

    def wopbs(self, ct: ShortintCiphertext,
              f: Callable[[int], int]) -> ShortintCiphertext:
        """WoP-PBS over message + carry (wopbs/mod.rs:544): extract the
        value's bits, circuit-bootstrap each into a GGSW, evaluate the LUT
        by vertical packing."""
        p = self.server_key.params
        mod_sup = p.message_modulus * p.carry_modulus
        nbits = mod_sup.bit_length() - 1
        bits = self.extract_bits(ct, 63 - nbits, nbits)
        ggsws = self.circuit_bootstrap(torch.stack(bits))
        out = self.vertical_packing(self.generate_lut(ct, f), list(ggsws))
        return ShortintCiphertext(
            ct=out, degree=max(f(v) % mod_sup for v in range(mod_sup)),
            noise_level=NOMINAL_NOISE, message_modulus=p.message_modulus,
            carry_modulus=p.carry_modulus, under_key="big")
