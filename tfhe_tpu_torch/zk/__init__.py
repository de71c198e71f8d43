"""Zero-knowledge proofs of knowledge for compact-list encryption.

The port's copy of ``tfhe_tpu/zk`` (the reference ``tfhe-zk-pok`` crate):
the proof math runs on the host (arbitrary-precision pairing arithmetic,
with the BLS12-446 hot loops in ``csrc/bls446.c``); a verified list expands
into the batched ciphertext path on the device.
Two schemes, as in the reference: pke v1 (per-coordinate bit range proofs,
``proofs/pke.rs``) and pke v2 (euclidean norm bound via four-square
witness + 128 random projections, ``proofs/pke_v2/``; shorter proofs).
"""

from .curve import G1, G2, Fr, pairing
from .four_squares import four_squares
from .pke import PkeCrs, PkeProof, prove, verify
from .pke_v2 import PkeV2Crs, PkeV2Proof
from .proven_list import (
    ProvenCompactCiphertextList,
    crs_for_params,
    crs_for_params_v2,
)
