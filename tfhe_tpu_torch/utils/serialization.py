"""Safe serialization: versioned envelope + size limits + conformance.

Torch counterpart of ``tfhe_tpu/utils/serialization.py`` (reference
``tfhe/src/safe_serialization.rs:151-300`` and the ``tfhe-versionable``
upgrade chains). The format is ``tfhe_tpu``'s, byte for byte:

    magic(8) | header_len(u32 LE) | header JSON | raw array payloads

The header records the type name, type version, framework version,
metadata (ints/strings) and, for each array, its numpy dtype, shape and
byte offset. The port holds torus values in ``int64`` and the CRT keys in
``int32``: they are written as the ``uint64`` / ``uint32`` arrays
``tfhe_tpu`` writes, so an envelope of the port equals ``tfhe_tpu``'s for
the same object and each package reads what the other wrote.
:func:`deserialize` places tensors on ``device`` (the GPU when unset).
The ZK types (``PkeV2Crs``, ``PkeV2Proof``) are host objects of ``zk/``:
their envelopes hold raw point bytes and load on the host.
"""

from __future__ import annotations

import dataclasses
import io
import json
from typing import Any, Callable, Optional

import numpy as np
import torch

from .._torus import to_u32, to_u64

MAGIC = b"TFHETPU1"
FRAMEWORK_VERSION = "0.1.0"

# type registry: name -> (version, from_payload(payload, device), upgrade
# hooks {old_ver: fn})
_REGISTRY: dict = {}


def register_type(name: str, version: int, from_payload: Callable,
                  upgrades: Optional[dict] = None):
    _REGISTRY[name] = (version, from_payload, upgrades or {})


class SerializationError(Exception):
    pass


def serialize(type_name: str, meta: dict, arrays: dict,
              version: Optional[int] = None) -> bytes:
    """Serialize ``meta`` (JSON-able) + named numpy arrays under the
    registered ``type_name`` envelope."""
    if type_name not in _REGISTRY:
        raise SerializationError(f"type {type_name!r} is not registered")
    ver = version if version is not None else _REGISTRY[type_name][0]
    blobs = []
    arr_index = {}
    offset = 0
    for k, a in arrays.items():
        a = np.ascontiguousarray(a)
        raw = a.tobytes()
        arr_index[k] = {"dtype": str(a.dtype), "shape": list(a.shape),
                        "offset": offset, "nbytes": len(raw)}
        blobs.append(raw)
        offset += len(raw)
    header = {
        "type": type_name,
        "type_version": ver,
        "framework_version": FRAMEWORK_VERSION,
        "meta": meta,
        "arrays": arr_index,
    }
    hj = json.dumps(header).encode()
    out = io.BytesIO()
    out.write(MAGIC)
    out.write(len(hj).to_bytes(4, "little"))
    out.write(hj)
    for b in blobs:
        out.write(b)
    return out.getvalue()


def deserialize(data: bytes, expected_type: Optional[str] = None,
                size_limit: Optional[int] = None,
                conformance: Optional[Callable[[dict], bool]] = None,
                device=None) -> Any:
    """Parse an envelope into the port's object, its tensors on ``device``
    (the GPU when unset): checks the magic, the size limit, the registered
    type, the optional conformance predicate on the header and every array
    spec against the payload; runs the upgrade chain."""
    if size_limit is not None and len(data) > size_limit:
        raise SerializationError(
            f"payload of {len(data)} bytes exceeds the size limit {size_limit}"
        )
    if data[:8] != MAGIC:
        raise SerializationError("bad magic (not a tfhe_tpu serialized object)")
    hlen = int.from_bytes(data[8:12], "little")
    header = json.loads(data[12:12 + hlen])
    tname = header["type"]
    if expected_type is not None and tname != expected_type:
        raise SerializationError(f"expected type {expected_type!r}, found {tname!r}")
    if tname not in _REGISTRY:
        raise SerializationError(f"unknown serialized type {tname!r}")
    cur_ver, from_payload, upgrades = _REGISTRY[tname]
    if conformance is not None and not conformance(header):
        raise SerializationError("conformance check failed")
    base = 12 + hlen
    avail = len(data) - base
    arrays = {}
    for k, spec in header["arrays"].items():
        off, nbytes = int(spec["offset"]), int(spec["nbytes"])
        dt = np.dtype(spec["dtype"])
        shape = tuple(int(d) for d in spec["shape"])
        if any(d < 0 for d in shape):
            raise SerializationError(f"array {k!r}: negative dimension")
        want = int(np.prod(shape, dtype=np.int64)) * dt.itemsize
        # untrusted header: every bound checked before slicing (a negative
        # offset would otherwise silently read header bytes)
        if off < 0 or nbytes < 0 or off + nbytes > avail or nbytes != want:
            raise SerializationError(
                f"array {k!r}: bad spec offset={off} nbytes={nbytes} "
                f"(payload {avail} bytes, shape needs {want})"
            )
        raw = data[base + off:base + off + nbytes]
        arrays[k] = np.frombuffer(raw, dtype=dt).reshape(shape).copy()
    payload = {"meta": header["meta"], "arrays": arrays}
    ver = header["type_version"]
    while ver < cur_ver:
        if ver not in upgrades:
            raise SerializationError(
                f"no upgrade path for {tname!r} from version {ver}"
            )
        payload = upgrades[ver](payload)
        ver += 1
    if ver > cur_ver:
        raise SerializationError(
            f"{tname!r} version {ver} is newer than supported {cur_ver}"
        )
    return from_payload(payload, device)


# ---------------------------------------------------------------------------
# registrations for the core user-facing types
# ---------------------------------------------------------------------------

def _u64(x) -> np.ndarray:
    """A torus array (int64 tensor or numpy) as the u64 numpy array that
    ``tfhe_tpu`` stores."""
    if isinstance(x, torch.Tensor):
        return to_u64(x)
    return np.asarray(x, dtype=np.uint64)


def _params_from_name(name: str):
    from .params import PARAMS_BY_NAME

    return PARAMS_BY_NAME[name]


def serialize_radix(ct) -> bytes:
    """A radix ciphertext of the server (``integer.radix``) or of the thin
    client (``client.ClientRadixCiphertext``)."""
    return serialize(
        "RadixCiphertext",
        {"message_modulus": ct.message_modulus,
         "carry_modulus": ct.carry_modulus},
        {"ct": _u64(ct.ct), "degrees": np.asarray(ct.degrees),
         "noise_levels": np.asarray(ct.noise_levels)},
    )


def _radix_from(payload, device):
    from .._device import resolve_device
    from .._torus import from_u64
    from ..integer.radix import RadixCiphertext

    m = payload["meta"]
    a = payload["arrays"]
    return RadixCiphertext(
        ct=from_u64(a["ct"], resolve_device(device)), degrees=a["degrees"],
        noise_levels=a["noise_levels"],
        message_modulus=m["message_modulus"], carry_modulus=m["carry_modulus"],
    )


def serialize_shortint_client_key(ck) -> bytes:
    """The client key as its parameter set's name and root seed, with the
    secret bits for the integrity check of the load. A key carried in
    without its seed (``convert.client_key_from_arrays``) cannot be
    written: the load regenerates the key from the seed."""
    if ck._enc_gen is None:
        raise SerializationError(
            "this client key carries no seed (it was carried in from its "
            "secret bits); only a key made by ClientKey.generate can be "
            "serialized")
    return serialize(
        "ShortintClientKey",
        {"params": ck.params.name, "seed": ck.seed},
        {"glwe_bits": _u64(ck.glwe_sk.bits),
         "lwe_bits": _u64(ck.lwe_sk.bits)},
    )


def _shortint_ck_from(payload, device):
    from ..shortint.client_key import ClientKey

    m = payload["meta"]
    # regenerate deterministically from the stored seed: secret bits are
    # checked against the stored arrays for integrity
    ck = ClientKey.generate(_params_from_name(m["params"]), m["seed"],
                            device=device)
    a = payload["arrays"]
    if not (np.array_equal(_u64(ck.glwe_sk.bits), a["glwe_bits"])
            and np.array_equal(_u64(ck.lwe_sk.bits), a["lwe_bits"])):
        raise SerializationError("stored secret key does not match its seed")
    return ck


def server_key_arrays(sk) -> dict:
    """``tfhe_tpu``'s stored form of a server key, what its serialization
    and its keycache hold: the KSK u64, its int8 limbs and the exact CRT
    key in scan layout u32 (a multi-bit key: the residue layout), whatever
    variant the key was prepared for. The drift technique's encryptions of
    zero are not stored, as in ``tfhe_tpu`` (ROADMAP standing note 13)."""
    return {"ksk": _u64(sk.ksk), "ksk_i8": sk.ksk_i8.cpu().numpy(),
            "bsk_scan": to_u32(sk.stored_bsk())}


def serialize_shortint_server_key(sk) -> bytes:
    arrays = server_key_arrays(sk)
    bsk = arrays["bsk_scan"]  # P on axis 2, a multi-bit key's on axis 1
    return serialize(
        "ShortintServerKey",
        {"params": sk.params.name,
         "num_primes": bsk.shape[1 if sk.bsk_mb is not None else 2],
         "max_degree": sk.max_degree},
        arrays,
    )


def _shortint_sk_from(payload, device):
    from ..shortint.server_key import ServerKey

    m = payload["meta"]
    a = payload["arrays"]
    sk = ServerKey.from_stored(_params_from_name(m["params"]), a["ksk"],
                               a["bsk_scan"], m["num_primes"], device)
    sk.max_degree = m["max_degree"]
    return sk


def serialize_shortint_ciphertext(ct) -> bytes:
    return serialize(
        "ShortintCiphertext",
        {"degree": ct.degree, "noise_level": ct.noise_level,
         "message_modulus": ct.message_modulus,
         "carry_modulus": ct.carry_modulus, "under_key": ct.under_key},
        {"ct": _u64(ct.ct)},
    )


def _shortint_ct_from(payload, device):
    from .._device import resolve_device
    from .._torus import from_u64
    from ..shortint.ciphertext import ShortintCiphertext

    m = payload["meta"]
    return ShortintCiphertext(
        ct=from_u64(payload["arrays"]["ct"], resolve_device(device)),
        degree=m["degree"], noise_level=m["noise_level"],
        message_modulus=m["message_modulus"],
        carry_modulus=m["carry_modulus"], under_key=m["under_key"],
    )


def serialize_squashed_ciphertext(ct) -> bytes:
    return serialize(
        "SquashedNoiseCiphertext",
        {"degree": ct.degree, "message_modulus": ct.message_modulus,
         "carry_modulus": ct.carry_modulus},
        {"hi": to_u64(ct.hi), "lo": to_u64(ct.lo)},
    )


def _squashed_ct_from(payload, device):
    from .._device import resolve_device
    from .._torus import from_u64
    from ..shortint.noise_squashing import SquashedNoiseCiphertext

    m = payload["meta"]
    a = payload["arrays"]
    dev = resolve_device(device)
    return SquashedNoiseCiphertext(
        hi=from_u64(a["hi"], dev), lo=from_u64(a["lo"], dev),
        degree=m["degree"], message_modulus=m["message_modulus"],
        carry_modulus=m["carry_modulus"])


def _dist_to_meta(d) -> list:
    return [d.kind, d.std_dev, d.bound_log2]


def _dist_from_meta(v):
    from .params import DynamicDistribution

    return DynamicDistribution(kind=v[0], std_dev=v[1], bound_log2=v[2])


def _comp_params_meta(p) -> dict:
    d = dataclasses.asdict(p)
    d["packing_ks_key_noise_distribution"] = _dist_to_meta(
        p.packing_ks_key_noise_distribution)
    return d


def _comp_params_from(meta: dict):
    from .params import CiphertextModulus, CompressionParameters

    d = dict(meta)
    d["packing_ks_key_noise_distribution"] = _dist_from_meta(
        d["packing_ks_key_noise_distribution"])
    # asdict() flattens a nested CiphertextModulus dataclass to a dict
    if isinstance(d.get("ciphertext_modulus"), dict):
        d["ciphertext_modulus"] = CiphertextModulus(**d["ciphertext_modulus"])
    return CompressionParameters(**d)


def serialize_compressed_list(cl) -> bytes:
    return serialize(
        "CompressedCiphertextList",
        {"count": cl.count, "message_modulus": cl.message_modulus,
         "carry_modulus": cl.carry_modulus,
         "comp_params": _comp_params_meta(cl.params)},
        {"storage": to_u32(cl.storage)},
    )


def _compressed_list_from(payload, device):
    from .._device import resolve_device
    from .._torus import from_u32
    from ..shortint.list_compression import CompressedCiphertextList

    m = payload["meta"]
    return CompressedCiphertextList(
        storage=from_u32(payload["arrays"]["storage"],
                         resolve_device(device)),
        count=m["count"], message_modulus=m["message_modulus"],
        carry_modulus=m["carry_modulus"],
        params=_comp_params_from(m["comp_params"]),
    )


def _cpk_params_meta(p) -> dict:
    """Full CompactPublicKeyEncryptionParameters fields (self-contained: a
    list built with unregistered custom parameters must still round-trip;
    cf. _comp_params_meta for CompressionParameters)."""
    return {
        "name": p.name,
        "encryption_lwe_dimension": p.encryption_lwe_dimension,
        "encryption_noise_distribution": _dist_to_meta(
            p.encryption_noise_distribution),
        "message_modulus": p.message_modulus,
        "carry_modulus": p.carry_modulus,
        "expansion_kind": p.expansion_kind,
        "zk_scheme": p.zk_scheme,
        "ciphertext_modulus": [p.ciphertext_modulus.value,
                               p.ciphertext_modulus.bits],
    }


def _cpk_params_from(meta: dict):
    from .params import (CiphertextModulus,
                         CompactPublicKeyEncryptionParameters)

    d = dict(meta)
    d["encryption_noise_distribution"] = _dist_from_meta(
        d["encryption_noise_distribution"])
    d["ciphertext_modulus"] = CiphertextModulus(*d["ciphertext_modulus"])
    return CompactPublicKeyEncryptionParameters(**d)


def serialize_compact_list(cl) -> bytes:
    return serialize(
        "CompactCiphertextList",
        {"count": cl.count, "degree": cl.degree,
         "cpk_params": _cpk_params_meta(cl.params)},
        {"masks": _u64(cl.masks), "bodies": _u64(cl.bodies)},
    )


def _compact_list_upgrade_v1(payload):
    """v1 stored only the parameter-set NAME; resolve via the registry
    (raising SerializationError, not KeyError, for unregistered names)."""
    m = dict(payload["meta"])
    name = m.pop("params")
    try:
        p = _params_from_name(name)
    except KeyError:
        raise SerializationError(
            f"CompactCiphertextList v1 references unregistered parameter "
            f"set {name!r}; re-serialize with a current version (v2 stores "
            f"the full parameter struct)") from None
    m["cpk_params"] = _cpk_params_meta(p)
    return {"meta": m, "arrays": payload["arrays"]}


def _compact_list_from(payload, device):
    from .._device import resolve_device
    from .._torus import from_u64
    from ..shortint.compact_public_key import CompactCiphertextList

    m = payload["meta"]
    a = payload["arrays"]
    dev = resolve_device(device)
    return CompactCiphertextList(
        masks=from_u64(a["masks"], dev), bodies=from_u64(a["bodies"], dev),
        count=m["count"], params=_cpk_params_from(m["cpk_params"]),
        degree=m["degree"],
    )


def serialize_zk_crs(crs) -> bytes:
    """``tfhe_tpu``'s ``PkeV2Crs`` envelope: the punctured powers-of-alpha
    lists as raw point bytes (112 B a G1, 224 B a G2, the zero point all
    zero bytes), the scalar fields in the header, ``ds`` as hex."""
    g = np.frombuffer(
        b"".join(p.to_bytes() for p in crs.g_list), dtype=np.uint8)
    gh = np.frombuffer(
        b"".join(p.to_bytes() for p in crs.g_hat_list), dtype=np.uint8)
    meta = {k: getattr(crs, k) for k in (
        "d", "k", "b_inf", "q", "t", "pad_bits", "bound_type", "n", "big_d",
        "b_bound_squared", "m_bound", "sid")}
    meta["ds"] = crs.ds.hex()
    return serialize("PkeV2Crs", meta, {"g_list": g, "g_hat_list": gh})


def _zk_crs_from(payload, device):
    """Every point is checked as ``tfhe_tpu``'s loader checks it (canonical,
    on the curve, in the prime-order subgroup); the subgroup checks of the
    whole CRS run at once (``zk.curve.check_subgroup_many``)."""
    from ..zk.curve import G1, G2, InvalidPointError, check_subgroup_many
    from ..zk.pke_v2 import PkeV2Crs

    m = dict(payload["meta"])
    ds = bytes.fromhex(m.pop("ds"))
    a = payload["arrays"]
    raw_g = a["g_list"].tobytes()
    raw_gh = a["g_hat_list"].tobytes()
    try:
        g_list = [G1.from_bytes(raw_g[i:i + 112], check_subgroup=False)
                  for i in range(0, len(raw_g), 112)]
        gh_list = [G2.from_bytes(raw_gh[i:i + 224], check_subgroup=False)
                   for i in range(0, len(raw_gh), 224)]
        check_subgroup_many(g_list + gh_list)
    except InvalidPointError as e:
        raise SerializationError(f"PkeV2Crs: {e}") from e
    return PkeV2Crs(g_list=g_list, g_hat_list=gh_list, ds=ds, **m)


#: the points of a ``PkeV2Proof``, in envelope order; the G2 ones
PROOF_FIELDS = ("C_hat_e", "C_e", "C_r_tilde", "C_R", "C_hat_bin", "C_y",
                "C_h1", "C_h2", "C_hat_t", "pi", "pi_kzg", "C_hat_h3",
                "C_hat_w")
_PROOF_G2 = {"C_hat_e", "C_hat_bin", "C_hat_t", "C_hat_h3", "C_hat_w"}


def serialize_zk_proof(proof) -> bytes:
    """``tfhe_tpu``'s ``PkeV2Proof`` envelope: each point's raw bytes."""
    blobs = {f: np.frombuffer(getattr(proof, f).to_bytes(), dtype=np.uint8)
             for f in PROOF_FIELDS}
    return serialize("PkeV2Proof", {}, blobs)


def _zk_proof_from(payload, device):
    from ..zk.curve import G1, G2, InvalidPointError
    from ..zk.pke_v2 import PkeV2Proof

    a = payload["arrays"]
    kwargs = {}
    for f in PROOF_FIELDS:
        cls = G2 if f in _PROOF_G2 else G1
        try:
            kwargs[f] = cls.from_bytes(a[f].tobytes())
        except InvalidPointError as e:
            raise SerializationError(f"PkeV2Proof.{f}: {e}") from e
    return PkeV2Proof(**kwargs)


def serialize_compressed_server_key(csk) -> bytes:
    """``tfhe_tpu``'s ``CompressedServerKey`` envelope
    (``shortint/compressed_server_key.py:137-171``): the bodies and the
    mask stream's coordinates, the seed as hex text."""
    return serialize(
        "CompressedServerKey",
        {"params": csk.params.name, "mask_seed": hex(csk.mask_seed),
         "bsk_mask_start": csk.bsk_mask_start,
         "ksk_mask_start": csk.ksk_mask_start,
         "max_degree": csk.max_degree},
        {"bsk_bodies": _u64(csk.bsk_bodies),
         "ksk_bodies": _u64(csk.ksk_bodies)},
    )


def _compressed_server_key_from(payload, device):
    from .._device import resolve_device
    from .._torus import from_u64
    from ..shortint.compressed_server_key import CompressedServerKey

    m = payload["meta"]
    a = payload["arrays"]
    dev = resolve_device(device)
    return CompressedServerKey(
        params=_params_from_name(m["params"]),
        bsk_bodies=from_u64(a["bsk_bodies"], dev),
        ksk_bodies=from_u64(a["ksk_bodies"], dev),
        mask_seed=int(m["mask_seed"], 16),
        bsk_mask_start=m["bsk_mask_start"],
        ksk_mask_start=m["ksk_mask_start"], max_degree=m["max_degree"])


register_type("RadixCiphertext", 1, _radix_from)
register_type("ShortintClientKey", 1, _shortint_ck_from)
register_type("ShortintServerKey", 1, _shortint_sk_from)
register_type("ShortintCiphertext", 1, _shortint_ct_from)
register_type("SquashedNoiseCiphertext", 1, _squashed_ct_from)
register_type("CompressedCiphertextList", 1, _compressed_list_from)
register_type("CompactCiphertextList", 2, _compact_list_from,
              upgrades={1: _compact_list_upgrade_v1})
register_type("PkeV2Crs", 1, _zk_crs_from)
register_type("PkeV2Proof", 1, _zk_proof_from)
register_type("CompressedServerKey", 1, _compressed_server_key_from)


def conformance_params(expected_param_name: str) -> Callable[[dict], bool]:
    """Conformance predicate factory (reference conformance.rs): the stored
    object must have been produced under the expected parameter set."""
    def check(header: dict) -> bool:
        return header["meta"].get("params") == expected_param_name

    return check
