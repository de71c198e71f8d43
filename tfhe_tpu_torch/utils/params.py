"""Cryptographic parameter sets (the port's own copy).

A field-for-field copy of the classes of ``tfhe_tpu/utils/params.py`` that
the shortint main path and the boolean layer read, and of seven of its
named sets: the shortint 2_2 default, 1_1 and the insecure CI toy set
(values from ``tfhe/src/shortint/parameters/v1_4/classic/gaussian/
p_fail_2_minus_128/ks_pbs.rs``), and the four boolean sets (``tfhe/src/
boolean/parameters/``).
"""

from __future__ import annotations

import enum
from dataclasses import dataclass, replace
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


NATIVE_U64 = CiphertextModulus(0, 64)


@dataclass(frozen=True)
class ModulusSwitchNoiseReductionParams:
    """Drift-technique modulus-switch parameters (not on this slice's
    path; kept so the parameter class stays field-for-field)."""

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


_G = DynamicDistribution.gaussian_from_std_dev

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

PARAMS_BY_NAME = {
    p.name: p
    for p in (
        PARAM_MESSAGE_2_CARRY_2_KS_PBS,
        PARAM_MESSAGE_1_CARRY_1_KS_PBS,
        PARAM_TEST_TOY,
    )
}


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
