"""The port's C API (``tfhe_tpu_torch/c_api/``), built with cc into
``tfhe_tpu_torch/_build/`` (``_build.c_api_build``), on the CPU:

- ``c_api_test`` (the checks of ``c_api/tests/c_api_test.c``: keygen, add,
  bitand, scalar mul, ge, max, scalar shl, not, the serialization round
  trip) run with device ``cpu`` at PARAM_TEST_TOY, seed 42; the serialized
  sum it writes byte-equal to tfhe_tpu's HLAPI computing
  ``FheUint8(27) + FheUint8(15)`` under ``Config(PARAM_TEST_TOY, 42)``;
- ``tfhe_tpu_init()`` (the GPU) failing here with ``resolve_device``'s
  message, from the program and from the library loaded into this
  interpreter (``ctypes.PyDLL``), where an encrypt-add-decrypt on the CPU
  gives the same bytes;
- every declaration of ``c_api/tfhe_tpu.h`` unchanged in the port's header
  (``test_torch_isolation.py`` holds the C source to the port's modules).

Tolerance: exact (bytes)."""

import ctypes
import os
import re
import shutil
import subprocess

import pytest

from tfhe_tpu_torch import _build

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NO_GPU = "runs on a CUDA device by default and none is available"

needs_cc = pytest.mark.skipif(shutil.which("cc") is None,
                              reason="no C compiler")


def _run(*args):
    build = _build.c_api_build()
    return subprocess.run([build["program"], *args], capture_output=True,
                          text=True, env=_build.c_api_env(), timeout=300)


@pytest.fixture(scope="module")
def jax_sum():
    """tfhe_tpu's serialized FheUint8(27) + FheUint8(15) at PARAM_TEST_TOY,
    seed 42."""
    from tfhe_tpu.high_level_api import api
    from tfhe_tpu.utils import serialization
    from tfhe_tpu.utils.params import PARAM_TEST_TOY

    ck, sk = api.generate_keys(api.Config(PARAM_TEST_TOY, 42))
    api.set_server_key(sk)
    try:
        total = api.FheUint8.encrypt(27, ck) + api.FheUint8.encrypt(15, ck)
        return serialization.serialize_radix(total.ct)
    finally:
        api.unset_server_key()


@needs_cc
def test_c_api_test_on_the_cpu(jax_sum, tmp_path):
    out = tmp_path / "sum.bin"
    run = _run("cpu", "PARAM_TEST_TOY", str(out), "42")
    assert run.returncode == 0, (run.stdout[-1000:], run.stderr[-2000:])
    assert "c_api_test OK" in run.stdout
    ops = re.findall(r"^op (\w+) ([0-9.]+) ms$", run.stderr, re.M)
    assert {name for name, _ in ops} >= {"init", "generate_keys", "add",
                                         "serialize", "deserialize"}
    assert out.read_bytes() == jax_sum


@needs_cc
def test_init_without_a_gpu_fails_with_the_reason():
    run = _run()  # device "gpu": tfhe_tpu_init()
    assert run.returncode == 1 and "c_api_test OK" not in run.stdout
    assert "FAIL tfhe_tpu_init()" in run.stderr and NO_GPU in run.stderr


@needs_cc
def test_library_in_this_interpreter(jax_sum):
    """The library loaded into the running interpreter: tfhe_tpu_init()
    fails as the program does; on the CPU one encrypt-add-decrypt and the
    sum's bytes equal tfhe_tpu's."""
    from tfhe_tpu_torch.high_level_api import api

    lib = _build.c_api_lib()
    assert lib.tfhe_tpu_init() == 1
    assert NO_GPU in lib.tfhe_tpu_last_error().decode()
    assert lib.tfhe_tpu_init_on(b"cpu") == 0
    ck, sk, a, b, total = (ctypes.c_void_p() for _ in range(5))
    try:
        assert lib.tfhe_tpu_generate_keys(b"PARAM_TEST_TOY", 42,
                                          ctypes.byref(ck),
                                          ctypes.byref(sk)) == 0
        assert lib.tfhe_tpu_set_server_key(sk) == 0
        assert lib.tfhe_tpu_fheuint_encrypt(8, 27, ck, ctypes.byref(a)) == 0
        assert lib.tfhe_tpu_fheuint_encrypt(8, 15, ck, ctypes.byref(b)) == 0
        assert lib.tfhe_tpu_fheuint_add(a, b, ctypes.byref(total)) == 0
        clear = ctypes.c_uint64()
        assert lib.tfhe_tpu_fheuint_decrypt(total, ck,
                                            ctypes.byref(clear)) == 0
        assert clear.value == 42
        buf = ctypes.POINTER(ctypes.c_uint8)()
        size = ctypes.c_size_t()
        assert lib.tfhe_tpu_fheuint_serialize(total, ctypes.byref(buf),
                                              ctypes.byref(size)) == 0
        assert ctypes.string_at(buf, size.value) == jax_sum
        lib.tfhe_tpu_buffer_destroy(buf, size)
    finally:
        for h in (a, b, total):
            lib.tfhe_tpu_fheuint_destroy(h)
        lib.tfhe_tpu_client_key_destroy(ck)
        lib.tfhe_tpu_server_key_destroy(sk)
        lib.tfhe_tpu_shutdown()
        api.unset_server_key()


def _declarations(path):
    """The header's declarations (typedefs and prototypes), whitespace
    normalized, comments and preprocessor lines dropped."""
    text = re.sub(r"/\*.*?\*/", "", open(path).read(), flags=re.S)
    text = "\n".join(line for line in text.splitlines()
                     if not line.lstrip().startswith("#"))
    text = text.replace('extern "C" {', "")
    return {" ".join(d.split()) for d in text.split(";")
            if "(" in d or "typedef" in d}


def test_header_keeps_every_declaration():
    ours = _declarations(os.path.join(_build.C_API, "tfhe_tpu.h"))
    theirs = _declarations(os.path.join(ROOT, "c_api", "tfhe_tpu.h"))
    assert len(theirs) == 39  # 3 handle typedefs, 36 functions
    assert theirs <= ours
    assert ours - theirs == {"int tfhe_tpu_init_on(const char *device)"}
