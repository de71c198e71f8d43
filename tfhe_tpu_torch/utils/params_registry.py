"""Materialize the parameter universe into typed dataclasses (the port's
copy of ``tfhe_tpu/utils/params_registry.py``).

``params_universe.RAW_PARAMS`` (a verbatim copy of the JAX package's table,
generated from the reference's ``shortint/parameters`` constants) holds
plain-data tuples; this module turns them into the dataclasses of
:mod:`tfhe_tpu_torch.utils.params` and exposes the full registry:

    >>> from tfhe_tpu_torch.utils.params_registry import UNIVERSE
    >>> UNIVERSE['PARAM_MESSAGE_2_CARRY_2_KS_PBS'].lwe_dimension
    918

Covers every reference alias (``shortint/parameters/aliases.rs``) plus the
whole ``current_params`` (v1_5) tree: classic/multibit x gaussian/tuniform
x pfail 2^-40/64/128 tiers, KS32, compression, noise squashing,
compact-PK, key switching, and meta bundles.
"""

from __future__ import annotations

import functools

from . import params as P
from .params_universe import RAW_PARAMS

# Hand-registered sets OUTSIDE the generated v1_5 universe. The v1_3 KS32
# tier is the reference's production consumer of the drift-technique
# modulus-switch noise reduction (ModulusSwitchType::
# DriftTechniqueNoiseReduction, shortint/parameters/v1_3/ks32/tuniform/
# p_fail_2_minus_128/ks_pbs/mod.rs:13-38); v1_5 moved the CPU tiers to the
# centered-mean MS, so the generated universe has no drift set to exercise
# core_crypto/algorithms/modulus_switch_noise_reduction.rs.
EXTRA_PARAMS = {
    'V1_3_PARAM_MESSAGE_2_CARRY_2_KS32_PBS_TUNIFORM_2M128': (
        'KeySwitch32PBSParameters',
        {'lwe_dimension': 918, 'glwe_dimension': 1, 'polynomial_size': 2048,
         'lwe_noise_distribution': ('t_uniform', 13),
         'glwe_noise_distribution': ('t_uniform', 17),
         'pbs_base_log': 23, 'pbs_level': 1,
         'ks_base_log': 4, 'ks_level': 4,
         'message_modulus': 4, 'carry_modulus': 4, 'max_noise_level': 5,
         'log2_p_fail': -129.358380844,
         'post_keyswitch_ciphertext_modulus': ('native', 32),
         'ciphertext_modulus': ('native', None),
         'modulus_switch_noise_reduction_params': (
             'ms_drift',
             {'modulus_switch_zeros_count': 1449,
              'ms_bound': 67108864.0,
              'ms_r_sigma_factor': 13.179851302864899,
              'ms_input_variance': 2.63039392929833e-07})}),
}
RAW_PARAMS.update(EXTRA_PARAMS)


def _dist(v):
    kind, val = v
    if kind == "gaussian":
        return P.DynamicDistribution.gaussian_from_std_dev(val)
    if kind == "t_uniform":
        return P.DynamicDistribution.t_uniform(val)
    raise ValueError(v)


def _modulus(v, default_bits=64):
    if v[0] == "native":
        return P.CiphertextModulus.new_native(v[1] or default_bits)
    if v[0] == "modulus":
        return P.CiphertextModulus(v[1], v[2] or default_bits)
    raise ValueError(v)


def _ms(v):
    """-> (ModulusSwitchType, Optional[ModulusSwitchNoiseReductionParams])."""
    if v is None:
        return P.ModulusSwitchType.STANDARD, None
    if v[0] == "ms":
        return (
            P.ModulusSwitchType.STANDARD
            if v[1] == "standard"
            else P.ModulusSwitchType.CENTERED_MEAN_NOISE_REDUCTION
        ), None
    if v[0] == "ms_drift":
        f = v[1]
        return P.ModulusSwitchType.DRIFT_TECHNIQUE_NOISE_REDUCTION, (
            P.ModulusSwitchNoiseReductionParams(
                modulus_switch_zeros_count=f["modulus_switch_zeros_count"],
                ms_bound=f["ms_bound"],
                ms_r_sigma_factor=f["ms_r_sigma_factor"],
                ms_input_variance=f["ms_input_variance"],
            )
        )
    raise ValueError(v)


def _key_choice(v):
    return P.EncryptionKeyChoice.BIG if v[1] == "big" else P.EncryptionKeyChoice.SMALL


def _max_noise(v):
    if isinstance(v, tuple):  # MaxNoiseLevel::UNKNOWN (wopbs-era sets)
        return 1 << 30
    return v


def _build(name: str, seen=()):
    kind, f = RAW_PARAMS[name]
    if kind == "ClassicPBSParameters":
        ms_t, ms_p = _ms(f.get("modulus_switch_noise_reduction_params"))
        return P.ClassicPBSParameters(
            lwe_dimension=f["lwe_dimension"],
            glwe_dimension=f["glwe_dimension"],
            polynomial_size=f["polynomial_size"],
            lwe_noise_distribution=_dist(f["lwe_noise_distribution"]),
            glwe_noise_distribution=_dist(f["glwe_noise_distribution"]),
            pbs_base_log=f["pbs_base_log"],
            pbs_level=f["pbs_level"],
            ks_base_log=f["ks_base_log"],
            ks_level=f["ks_level"],
            message_modulus=f["message_modulus"],
            carry_modulus=f["carry_modulus"],
            max_noise_level=_max_noise(f["max_noise_level"]),
            log2_p_fail=f["log2_p_fail"],
            ciphertext_modulus=_modulus(f["ciphertext_modulus"]),
            encryption_key_choice=_key_choice(f["encryption_key_choice"]),
            modulus_switch_type=ms_t,
            modulus_switch_noise_reduction_params=ms_p,
            name=name,
        )
    if kind == "MultiBitPBSParameters":
        return P.MultiBitPBSParameters(
            lwe_dimension=f["lwe_dimension"],
            glwe_dimension=f["glwe_dimension"],
            polynomial_size=f["polynomial_size"],
            lwe_noise_distribution=_dist(f["lwe_noise_distribution"]),
            glwe_noise_distribution=_dist(f["glwe_noise_distribution"]),
            pbs_base_log=f["pbs_base_log"],
            pbs_level=f["pbs_level"],
            ks_base_log=f["ks_base_log"],
            ks_level=f["ks_level"],
            message_modulus=f["message_modulus"],
            carry_modulus=f["carry_modulus"],
            max_noise_level=_max_noise(f["max_noise_level"]),
            log2_p_fail=f["log2_p_fail"],
            grouping_factor=f["grouping_factor"],
            ciphertext_modulus=_modulus(f["ciphertext_modulus"]),
            encryption_key_choice=_key_choice(f["encryption_key_choice"]),
            deterministic_execution=f.get("deterministic_execution", False),
            name=name,
        )
    if kind == "KeySwitch32PBSParameters":
        ms_t, ms_p = _ms(f.get("modulus_switch_noise_reduction_params"))
        return P.KeySwitch32PBSParameters(
            lwe_dimension=f["lwe_dimension"],
            glwe_dimension=f["glwe_dimension"],
            polynomial_size=f["polynomial_size"],
            lwe_noise_distribution=_dist(f["lwe_noise_distribution"]),
            glwe_noise_distribution=_dist(f["glwe_noise_distribution"]),
            pbs_base_log=f["pbs_base_log"],
            pbs_level=f["pbs_level"],
            ks_base_log=f["ks_base_log"],
            ks_level=f["ks_level"],
            message_modulus=f["message_modulus"],
            carry_modulus=f["carry_modulus"],
            max_noise_level=_max_noise(f["max_noise_level"]),
            log2_p_fail=f["log2_p_fail"],
            post_keyswitch_ciphertext_modulus=_modulus(
                f["post_keyswitch_ciphertext_modulus"], 32
            ),
            ciphertext_modulus=_modulus(f["ciphertext_modulus"]),
            modulus_switch_type=ms_t,
            modulus_switch_noise_reduction_params=ms_p,
            name=name,
        )
    if kind in ("CompressionParameters::Classic", "CompressionParameters::MultiBit"):
        return P.CompressionParameters(
            br_level=f["br_level"],
            br_base_log=f["br_base_log"],
            packing_ks_level=f["packing_ks_level"],
            packing_ks_base_log=f["packing_ks_base_log"],
            packing_ks_polynomial_size=f["packing_ks_polynomial_size"],
            packing_ks_glwe_dimension=f["packing_ks_glwe_dimension"],
            lwe_per_glwe=f["lwe_per_glwe"],
            storage_log_modulus=f["storage_log_modulus"],
            packing_ks_key_noise_distribution=_dist(
                f["packing_ks_key_noise_distribution"]
            ),
            decompression_grouping_factor=f.get("decompression_grouping_factor", 0),
            name=name,
        )
    if kind in ("NoiseSquashingParameters::Classic", "NoiseSquashingParameters::MultiBit"):
        ms_t, ms_p = _ms(f.get("modulus_switch_noise_reduction_params"))
        return P.NoiseSquashingParameters(
            glwe_dimension=f["glwe_dimension"],
            polynomial_size=f["polynomial_size"],
            glwe_noise_distribution=_dist(f["glwe_noise_distribution"]),
            decomp_base_log=f["decomp_base_log"],
            decomp_level_count=f["decomp_level_count"],
            message_modulus=f["message_modulus"],
            carry_modulus=f["carry_modulus"],
            modulus_switch_type=ms_t,
            modulus_switch_noise_reduction_params=ms_p,
            grouping_factor=f.get("grouping_factor", 0),
            deterministic_execution=f.get("deterministic_execution", False),
            ciphertext_modulus=_modulus(f["ciphertext_modulus"], 128),
            name=name,
        )
    if kind == "NoiseSquashingCompressionParameters":
        return P.NoiseSquashingCompressionParameters(
            packing_ks_level=f["packing_ks_level"],
            packing_ks_base_log=f["packing_ks_base_log"],
            packing_ks_polynomial_size=f["packing_ks_polynomial_size"],
            packing_ks_glwe_dimension=f["packing_ks_glwe_dimension"],
            lwe_per_glwe=f["lwe_per_glwe"],
            packing_ks_key_noise_distribution=_dist(
                f["packing_ks_key_noise_distribution"]
            ),
            message_modulus=f["message_modulus"],
            carry_modulus=f["carry_modulus"],
            ciphertext_modulus=_modulus(f["ciphertext_modulus"], 128),
            name=name,
        )
    if kind == "CompactPublicKeyEncryptionParameters":
        exp = f["expansion_kind"]
        exp_s = (
            "requires_casting"
            if exp[0] == "expansion"
            else f"no_casting_{exp[1].lower()}"
        )
        return P.CompactPublicKeyEncryptionParameters(
            encryption_lwe_dimension=f["encryption_lwe_dimension"],
            encryption_noise_distribution=_dist(f["encryption_noise_distribution"]),
            message_modulus=f["message_modulus"],
            carry_modulus=f["carry_modulus"],
            expansion_kind=exp_s,
            zk_scheme=f["zk_scheme"][1].lower(),
            ciphertext_modulus=_modulus(f["ciphertext_modulus"]),
            name=name,
        )
    if kind == "ShortintKeySwitchingParameters":
        return P.ShortintKeySwitchingParameters(
            ks_base_log=f["ks_base_log"],
            ks_level=f["ks_level"],
            destination_key=_key_choice(f["destination_key"]),
            name=name,
        )
    if kind == "MetaParameters":
        def deref(v):
            if v is None or v == ("none",):
                return None
            if v[0] == "const_ref":
                return get(v[1])
            if v[0] == "wrapped":
                return deref(v[1] if len(v) == 2 else v[2])
            if v[0] == "nested":
                fields = v[2]
                return tuple(deref(x) for x in fields.values())
            raise ValueError(v)

        return P.MetaParameters(
            backend=f["backend"][1],
            compute_parameters=deref(f["compute_parameters"]),
            dedicated_compact_public_key_parameters=deref(
                f.get("dedicated_compact_public_key_parameters")
            ),
            compression_parameters=deref(f.get("compression_parameters")),
            noise_squashing_parameters=deref(f.get("noise_squashing_parameters")),
            name=name,
        )
    raise ValueError(f"unhandled parameter kind {kind!r} for {name}")


@functools.lru_cache(maxsize=None)
def get(name: str):
    """Materialize one named parameter set from the universe."""
    return _build(name)


class _Universe(dict):
    """Lazy name -> parameters mapping over the whole generated table."""

    def __missing__(self, name):
        v = get(name)
        self[name] = v
        return v

    def __contains__(self, name):
        return name in RAW_PARAMS or dict.__contains__(self, name)

    def names(self):
        return sorted(RAW_PARAMS)


UNIVERSE = _Universe()


def all_names(kind_prefix: str = "") -> list[str]:
    """All set names, optionally filtered by parameter kind."""
    return [
        n for n, (k, _) in sorted(RAW_PARAMS.items()) if k.startswith(kind_prefix)
    ]
