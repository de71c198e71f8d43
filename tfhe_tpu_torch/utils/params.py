"""Cryptographic parameter sets (the port's own copy).

A field-for-field copy of the classes of ``tfhe_tpu/utils/params.py`` and
of its named sets: the shortint 2_2 default, 1_1, the TUniform 2_2 set and
the insecure CI toy sets (values from ``tfhe/src/shortint/parameters/
v1_4/classic/``), the multi-bit sets, and the four boolean sets
(``tfhe/src/boolean/parameters/``). ``PARAMS_BY_NAME`` falls through to the
reference's v1.5 universe (``params_registry.UNIVERSE``) for every other
name.
"""

from __future__ import annotations

import enum
from dataclasses import dataclass, field, replace
from typing import Optional


class EncryptionKeyChoice(enum.Enum):
    """BIG: fresh ciphertexts live under the GLWE-derived key and the atomic
    pattern is KS -> PBS. SMALL: small-key ciphertexts, PBS -> KS order
    (reference ``shortint/parameters/mod.rs``)."""

    BIG = "big"
    SMALL = "small"


class ModulusSwitchType(enum.Enum):
    """Reference ``ModulusSwitchType`` in shortint parameters."""

    STANDARD = "standard"
    CENTERED_MEAN_NOISE_REDUCTION = "centered_mean"
    DRIFT_TECHNIQUE_NOISE_REDUCTION = "drift"


@dataclass(frozen=True)
class DynamicDistribution:
    """Gaussian (std-dev relative to the torus) or t-uniform with bound
    2^bound_log2 (reference ``commons/math/random/mod.rs``)."""

    kind: str  # 'gaussian' | 't_uniform'
    std_dev: float = 0.0
    bound_log2: int = 0

    @staticmethod
    def gaussian_from_std_dev(std: float) -> "DynamicDistribution":
        return DynamicDistribution(kind="gaussian", std_dev=std)

    @staticmethod
    def t_uniform(bound_log2: int) -> "DynamicDistribution":
        return DynamicDistribution(kind="t_uniform", bound_log2=bound_log2)

    def variance(self, modulus_value: float) -> float:
        """Variance in absolute (integer) units for a given modulus."""
        if self.kind == "gaussian":
            return (self.std_dev * modulus_value) ** 2
        # t-uniform on [-2^b, 2^b] with half-weight endpoints
        b = self.bound_log2
        return (2.0 ** (2 * b + 1) + 1.0) / 6.0


@dataclass(frozen=True)
class CiphertextModulus:
    """``value == 0`` denotes the native modulus 2^bits."""

    value: int = 0
    bits: int = 64

    @property
    def is_native(self) -> bool:
        return self.value == 0 or self.value == (1 << self.bits)

    @property
    def modulus_value(self) -> int:
        return (1 << self.bits) if self.is_native else self.value

    @staticmethod
    def new_native(bits: int = 64) -> "CiphertextModulus":
        return CiphertextModulus(0, bits)


NATIVE_U64 = CiphertextModulus(0, 64)


@dataclass(frozen=True)
class ModulusSwitchNoiseReductionParams:
    """Drift-technique modulus-switch noise reduction parameters
    (``core_crypto/algorithms/modulus_switch_noise_reduction.rs``)."""

    modulus_switch_zeros_count: int
    ms_bound: float
    ms_r_sigma_factor: float
    ms_input_variance: float


@dataclass(frozen=True)
class ClassicPBSParameters:
    """Reference ``ClassicPBSParameters`` (``shortint/parameters/mod.rs``)."""

    lwe_dimension: int
    glwe_dimension: int
    polynomial_size: int
    lwe_noise_distribution: DynamicDistribution
    glwe_noise_distribution: DynamicDistribution
    pbs_base_log: int
    pbs_level: int
    ks_base_log: int
    ks_level: int
    message_modulus: int
    carry_modulus: int
    max_noise_level: int
    log2_p_fail: float
    ciphertext_modulus: CiphertextModulus = NATIVE_U64
    encryption_key_choice: EncryptionKeyChoice = EncryptionKeyChoice.BIG
    modulus_switch_type: ModulusSwitchType = (
        ModulusSwitchType.CENTERED_MEAN_NOISE_REDUCTION
    )
    modulus_switch_noise_reduction_params: Optional[
        ModulusSwitchNoiseReductionParams
    ] = None
    name: str = ""

    @property
    def glwe_size(self) -> int:  # k + 1
        return self.glwe_dimension + 1

    @property
    def big_lwe_dimension(self) -> int:
        return self.glwe_dimension * self.polynomial_size

    @property
    def cleartext_modulus(self) -> int:
        return self.message_modulus * self.carry_modulus

    def with_name(self, name: str) -> "ClassicPBSParameters":
        return replace(self, name=name)


@dataclass(frozen=True)
class MultiBitPBSParameters:
    """Multi-bit PBS parameters (reference ``MultiBitPBSParameters``): the
    blind rotation takes ``grouping_factor`` mask values a step
    (``ops/server.py::multi_bit_group_steps``, K5 on the GPU)."""

    lwe_dimension: int
    glwe_dimension: int
    polynomial_size: int
    lwe_noise_distribution: DynamicDistribution
    glwe_noise_distribution: DynamicDistribution
    pbs_base_log: int
    pbs_level: int
    ks_base_log: int
    ks_level: int
    message_modulus: int
    carry_modulus: int
    max_noise_level: int
    log2_p_fail: float
    grouping_factor: int = 2
    ciphertext_modulus: CiphertextModulus = NATIVE_U64
    encryption_key_choice: EncryptionKeyChoice = EncryptionKeyChoice.BIG
    modulus_switch_type: ModulusSwitchType = ModulusSwitchType.STANDARD
    deterministic_execution: bool = False
    name: str = ""

    @property
    def glwe_size(self) -> int:
        return self.glwe_dimension + 1

    @property
    def big_lwe_dimension(self) -> int:
        return self.glwe_dimension * self.polynomial_size

    @property
    def cleartext_modulus(self) -> int:
        return self.message_modulus * self.carry_modulus


@dataclass(frozen=True)
class KeySwitch32PBSParameters:
    """KS32 atomic pattern: the keyswitch lands on a u32 ciphertext modulus
    and the PBS switches from 32 bits (reference
    ``shortint/parameters/ks32.rs:26``, ``atomic_pattern/ks32.rs``)."""

    lwe_dimension: int
    glwe_dimension: int
    polynomial_size: int
    lwe_noise_distribution: DynamicDistribution  # over the u32 torus
    glwe_noise_distribution: DynamicDistribution  # over the u64 torus
    pbs_base_log: int
    pbs_level: int
    ks_base_log: int
    ks_level: int
    message_modulus: int
    carry_modulus: int
    max_noise_level: int
    log2_p_fail: float
    post_keyswitch_ciphertext_modulus: CiphertextModulus = field(
        default_factory=lambda: CiphertextModulus.new_native(32))
    ciphertext_modulus: CiphertextModulus = NATIVE_U64
    modulus_switch_type: ModulusSwitchType = (
        ModulusSwitchType.CENTERED_MEAN_NOISE_REDUCTION
    )
    modulus_switch_noise_reduction_params: Optional[
        ModulusSwitchNoiseReductionParams
    ] = None
    name: str = ""
    # KS32 ciphertexts live under the big key; KS -> PBS order
    encryption_key_choice: EncryptionKeyChoice = EncryptionKeyChoice.BIG

    @property
    def glwe_size(self) -> int:
        return self.glwe_dimension + 1

    @property
    def big_lwe_dimension(self) -> int:
        return self.glwe_dimension * self.polynomial_size

    @property
    def cleartext_modulus(self) -> int:
        return self.message_modulus * self.carry_modulus


@dataclass(frozen=True)
class NoiseSquashingParameters:
    """Noise squashing (u128 PBS) parameters (reference
    ``shortint/parameters/noise_squashing.rs:106,120``); ``grouping_factor``
    0 for the classic variant, > 0 for multi-bit."""

    glwe_dimension: int
    polynomial_size: int
    glwe_noise_distribution: DynamicDistribution  # over the u128 torus
    decomp_base_log: int
    decomp_level_count: int
    message_modulus: int
    carry_modulus: int
    modulus_switch_type: ModulusSwitchType = ModulusSwitchType.STANDARD
    modulus_switch_noise_reduction_params: Optional[
        ModulusSwitchNoiseReductionParams
    ] = None
    grouping_factor: int = 0
    deterministic_execution: bool = False
    ciphertext_modulus: CiphertextModulus = field(
        default_factory=lambda: CiphertextModulus.new_native(128))
    name: str = ""

    @property
    def glwe_size(self) -> int:
        return self.glwe_dimension + 1


@dataclass(frozen=True)
class NoiseSquashingCompressionParameters:
    """Compression of noise-squashed ciphertexts (reference
    ``shortint/parameters/noise_squashing.rs:135``)."""

    packing_ks_level: int
    packing_ks_base_log: int
    packing_ks_polynomial_size: int
    packing_ks_glwe_dimension: int
    lwe_per_glwe: int
    packing_ks_key_noise_distribution: DynamicDistribution  # u128 torus
    message_modulus: int
    carry_modulus: int
    ciphertext_modulus: CiphertextModulus = field(
        default_factory=lambda: CiphertextModulus.new_native(128))
    name: str = ""


@dataclass(frozen=True)
class CompressionParameters:
    """List-compression parameters (reference
    ``ClassicCompressionParameters``,
    ``shortint/parameters/list_compression.rs``;
    ``tfhe_tpu/shortint/list_compression.py:37``)."""

    br_level: int
    br_base_log: int
    packing_ks_level: int
    packing_ks_base_log: int
    packing_ks_polynomial_size: int
    packing_ks_glwe_dimension: int
    lwe_per_glwe: int
    storage_log_modulus: int
    packing_ks_key_noise_distribution: DynamicDistribution
    # 0 = classic decompression; > 0 = the multi-bit decompression key's
    # grouping (reference MultiBitCompressionParameters)
    decompression_grouping_factor: int = 0
    name: str = ""


@dataclass(frozen=True)
class CompactPublicKeyEncryptionParameters:
    """Dedicated compact-public-key encryption parameters (reference
    ``shortint/parameters/compact_public_key_only.rs:47``)."""

    encryption_lwe_dimension: int
    encryption_noise_distribution: DynamicDistribution
    message_modulus: int
    carry_modulus: int
    expansion_kind: str = "requires_casting"  # or 'no_casting_<order>'
    zk_scheme: str = "v2"
    ciphertext_modulus: CiphertextModulus = NATIVE_U64
    name: str = ""


@dataclass(frozen=True)
class ShortintKeySwitchingParameters:
    """A key-switching key between two shortint keysets (reference
    ``shortint/parameters/key_switching.rs:11``)."""

    ks_base_log: int
    ks_level: int
    destination_key: EncryptionKeyChoice = EncryptionKeyChoice.BIG
    name: str = ""


@dataclass(frozen=True)
class MetaParameters:
    """A bundle of parameter sets (reference ``shortint/parameters/
    meta.rs``): the compute set plus optional dedicated-CPK, compression
    and noise-squashing companions."""

    backend: str  # 'cpu' | 'gpu' | 'hpu' (informational)
    compute_parameters: object
    dedicated_compact_public_key_parameters: Optional[tuple] = None
    compression_parameters: Optional[object] = None
    noise_squashing_parameters: Optional[object] = None
    name: str = ""


_G = DynamicDistribution.gaussian_from_std_dev
_T = DynamicDistribution.t_uniform

# Reference: v1_4/classic/gaussian/p_fail_2_minus_128/ks_pbs.rs:258-280
PARAM_MESSAGE_2_CARRY_2_KS_PBS = ClassicPBSParameters(
    lwe_dimension=866,
    glwe_dimension=1,
    polynomial_size=2048,
    lwe_noise_distribution=_G(2.046151696979124e-06),
    glwe_noise_distribution=_G(2.845267479601915e-15),
    pbs_base_log=23,
    pbs_level=1,
    ks_base_log=3,
    ks_level=5,
    message_modulus=4,
    carry_modulus=4,
    max_noise_level=5,
    log2_p_fail=-128.597,
    name="PARAM_MESSAGE_2_CARRY_2_KS_PBS",
)

# Reference: the same file's M1C1 entry
PARAM_MESSAGE_1_CARRY_1_KS_PBS = ClassicPBSParameters(
    lwe_dimension=837,
    glwe_dimension=4,
    polynomial_size=512,
    lwe_noise_distribution=_G(3.3747142481837397e-06),
    glwe_noise_distribution=_G(2.845267479601915e-15),
    pbs_base_log=23,
    pbs_level=1,
    ks_base_log=5,
    ks_level=3,
    message_modulus=2,
    carry_modulus=2,
    max_noise_level=3,
    log2_p_fail=-128.186,
    name="PARAM_MESSAGE_1_CARRY_1_KS_PBS",
)

# Small, *insecure* parameters for fast CI tests (N=256, low noise, tiny n).
PARAM_TEST_TOY = ClassicPBSParameters(
    lwe_dimension=16,
    glwe_dimension=1,
    polynomial_size=256,
    lwe_noise_distribution=_G(2.0 ** -40),
    glwe_noise_distribution=_G(2.0 ** -40),
    pbs_base_log=23,
    pbs_level=1,
    ks_base_log=3,
    ks_level=5,
    message_modulus=4,
    carry_modulus=4,
    max_noise_level=5,
    log2_p_fail=-64.0,
    name="PARAM_TEST_TOY",
)

# Reference alias PARAM_MESSAGE_2_CARRY_2_KS_PBS_TUNIFORM_2M128
# (v1_4/classic/tuniform/p_fail_2_minus_128/ks_pbs.rs)
PARAM_MESSAGE_2_CARRY_2_KS_PBS_TUNIFORM = ClassicPBSParameters(
    lwe_dimension=918,
    glwe_dimension=1,
    polynomial_size=2048,
    lwe_noise_distribution=_T(45),
    glwe_noise_distribution=_T(17),
    pbs_base_log=23,
    pbs_level=1,
    ks_base_log=4,
    ks_level=4,
    message_modulus=4,
    carry_modulus=4,
    max_noise_level=5,
    log2_p_fail=-129.581,
    name="PARAM_MESSAGE_2_CARRY_2_KS_PBS_TUNIFORM",
)

# Toy variants of the two other atomic patterns (insecure, CI only)
PARAM_TEST_TOY_PBS_KS = replace(
    PARAM_TEST_TOY, encryption_key_choice=EncryptionKeyChoice.SMALL,
    name="PARAM_TEST_TOY_PBS_KS")

PARAM_TEST_TOY_KS32 = KeySwitch32PBSParameters(
    lwe_dimension=16,
    glwe_dimension=1,
    polynomial_size=256,
    lwe_noise_distribution=_T(3),
    glwe_noise_distribution=_G(2.0 ** -40),
    pbs_base_log=23,
    pbs_level=1,
    ks_base_log=3,
    ks_level=5,
    message_modulus=4,
    carry_modulus=4,
    max_noise_level=5,
    log2_p_fail=-64.0,
    name="PARAM_TEST_TOY_KS32",
)

# Reference v1.5 alias -> v1_1 values
# (shortint/parameters/v1_1/multi_bit/gaussian/p_fail_2_minus_128/ks_pbs.rs)
PARAM_MULTI_BIT_GROUP_2_MESSAGE_2_CARRY_2_KS_PBS = MultiBitPBSParameters(
    lwe_dimension=904,
    glwe_dimension=1,
    polynomial_size=4096,
    lwe_noise_distribution=_G(1.0621869847945622e-06),
    glwe_noise_distribution=_G(2.168404344971009e-19),
    pbs_base_log=21,
    pbs_level=1,
    ks_base_log=4,
    ks_level=4,
    message_modulus=4,
    carry_modulus=4,
    max_noise_level=5,
    log2_p_fail=-128.138,
    grouping_factor=2,
    name="PARAM_MULTI_BIT_GROUP_2_MESSAGE_2_CARRY_2_KS_PBS",
)

PARAM_TEST_TOY_MULTI_BIT = MultiBitPBSParameters(
    lwe_dimension=16,
    glwe_dimension=1,
    polynomial_size=256,
    lwe_noise_distribution=_G(2.0 ** -40),
    glwe_noise_distribution=_G(2.0 ** -40),
    pbs_base_log=23,
    pbs_level=1,
    ks_base_log=3,
    ks_level=5,
    message_modulus=4,
    carry_modulus=4,
    max_noise_level=5,
    log2_p_fail=-64.0,
    grouping_factor=2,
    name="PARAM_TEST_TOY_MULTI_BIT",
)

# Small, *insecure* noise-squashing parameters for fast CI tests (the real
# sets live in params_registry, e.g.
# NOISE_SQUASHING_PARAM_MESSAGE_2_CARRY_2_KS_PBS_TUNIFORM_2M128).
PARAM_TEST_TOY_SQUASH = NoiseSquashingParameters(
    glwe_dimension=1,
    polynomial_size=256,
    glwe_noise_distribution=_T(3),
    decomp_base_log=24,
    decomp_level_count=3,
    message_modulus=4,
    carry_modulus=4,
    modulus_switch_type=ModulusSwitchType.STANDARD,
    name="PARAM_TEST_TOY_SQUASH",
)


class _ParamsByName(dict):
    """name -> parameters: the constants of this module first, then every
    name of the reference's v1.5 universe (``params_registry.UNIVERSE``),
    materialised at first lookup. ``PARAM_MESSAGE_2_CARRY_2_KS_PBS`` is
    the constant above (the GAUSSIAN_2M128 values, as in ``tfhe_tpu``);
    the universe's alias of that name means TUNIFORM_2M128."""

    def __missing__(self, name):
        from .params_registry import UNIVERSE

        v = UNIVERSE[name]
        self[name] = v
        return v

    def __contains__(self, name):
        if dict.__contains__(self, name):
            return True
        from .params_registry import RAW_PARAMS

        return name in RAW_PARAMS


PARAMS_BY_NAME = _ParamsByName({
    p.name: p
    for p in (
        PARAM_MESSAGE_2_CARRY_2_KS_PBS,
        PARAM_MESSAGE_1_CARRY_1_KS_PBS,
        PARAM_MESSAGE_2_CARRY_2_KS_PBS_TUNIFORM,
        PARAM_TEST_TOY,
        PARAM_TEST_TOY_PBS_KS,
        PARAM_TEST_TOY_KS32,
        PARAM_MULTI_BIT_GROUP_2_MESSAGE_2_CARRY_2_KS_PBS,
        PARAM_TEST_TOY_MULTI_BIT,
    )
})


@dataclass(frozen=True)
class BooleanParameters:
    """Boolean-layer parameters (reference ``tfhe/src/boolean/parameters/``)."""

    lwe_dimension: int
    glwe_dimension: int
    polynomial_size: int
    lwe_noise_distribution: DynamicDistribution
    glwe_noise_distribution: DynamicDistribution
    pbs_base_log: int
    pbs_level: int
    ks_base_log: int
    ks_level: int
    encryption_key_choice: EncryptionKeyChoice = EncryptionKeyChoice.SMALL
    ciphertext_modulus: CiphertextModulus = NATIVE_U64
    name: str = ""

    @property
    def glwe_size(self) -> int:
        return self.glwe_dimension + 1

    @property
    def big_lwe_dimension(self) -> int:
        return self.glwe_dimension * self.polynomial_size


# Reference: boolean/parameters/params.rs DEFAULT_PARAMETERS
BOOLEAN_DEFAULT_PARAMETERS = BooleanParameters(
    lwe_dimension=805,
    glwe_dimension=3,
    polynomial_size=512,
    lwe_noise_distribution=_G(5.8615896642671336e-06),
    glwe_noise_distribution=_G(9.315272083503367e-10),
    pbs_base_log=10,
    pbs_level=2,
    ks_base_log=3,
    ks_level=5,
    encryption_key_choice=EncryptionKeyChoice.SMALL,
    name="BOOLEAN_DEFAULT_PARAMETERS",
)

# Reference: boolean/parameters/params.rs DEFAULT_PARAMETERS_KS_PBS
BOOLEAN_DEFAULT_PARAMETERS_KS_PBS = BooleanParameters(
    lwe_dimension=739,
    glwe_dimension=3,
    polynomial_size=512,
    lwe_noise_distribution=_G(1.8304520733507305e-05),
    glwe_noise_distribution=_G(9.315272083503367e-10),
    pbs_base_log=10,
    pbs_level=2,
    ks_base_log=3,
    ks_level=4,
    encryption_key_choice=EncryptionKeyChoice.BIG,
    name="BOOLEAN_DEFAULT_PARAMETERS_KS_PBS",
)

# Reference: boolean/parameters/mod.rs:131 TFHE_LIB_PARAMETERS, the original
# TFHE-lib legacy set
BOOLEAN_TFHE_LIB_PARAMETERS = BooleanParameters(
    lwe_dimension=630,
    glwe_dimension=1,
    polynomial_size=1024,
    lwe_noise_distribution=_G(0.000030517578125),
    glwe_noise_distribution=_G(0.00000002980232238769531),
    pbs_base_log=7,
    pbs_level=3,
    ks_base_log=2,
    ks_level=8,
    encryption_key_choice=EncryptionKeyChoice.SMALL,
    name="BOOLEAN_TFHE_LIB_PARAMETERS",
)

# Small, *insecure* boolean parameters for fast CI tests.
BOOLEAN_TEST_TOY = BooleanParameters(
    lwe_dimension=16,
    glwe_dimension=2,
    polynomial_size=256,
    lwe_noise_distribution=_G(2.0 ** -40),
    glwe_noise_distribution=_G(2.0 ** -40),
    pbs_base_log=10,
    pbs_level=2,
    ks_base_log=3,
    ks_level=4,
    encryption_key_choice=EncryptionKeyChoice.SMALL,
    name="BOOLEAN_TEST_TOY",
)

BOOLEAN_PARAMS_BY_NAME = {
    p.name: p
    for p in (
        BOOLEAN_DEFAULT_PARAMETERS,
        BOOLEAN_DEFAULT_PARAMETERS_KS_PBS,
        BOOLEAN_TFHE_LIB_PARAMETERS,
        BOOLEAN_TEST_TOY,
    )
}
