"""The port's twin of ``apps/test_vectors.py``
(``tfhe_tpu_torch.apps.test_vectors``) on the CPU: every intermediate of
the toy KS -> PBS (seed 0x74666865, n = 10, N = 256, noise 0; the blind
rotations on the plain K2 u64 -> K3) equals the golden ``.npy`` files of
``apps/test_vectors_data/`` in dtype, shape and value, and ``check``
reproduces every SHA-256 of its ``checksums.json``; a wrong sum fails the
check. Tolerance: exact."""

import json
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest

from test_torch_strings import one_torch_thread  # noqa: F401

from tfhe_tpu_torch.apps import test_vectors as tv

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NAMES = sorted(json.load(open(os.path.join(tv.DATA_DIR, "checksums.json"))))


@pytest.fixture(scope="module")
def vecs():
    return tv.vectors(*tv.keys("cpu"))


def test_data_dir_is_the_repo_copy():
    assert os.path.samefile(tv.DATA_DIR,
                            os.path.join(ROOT, "apps", "test_vectors_data"))
    assert len(NAMES) == 13


@pytest.mark.parametrize("name", NAMES)
def test_vector_equals_golden_file(vecs, name):
    want = np.load(os.path.join(tv.DATA_DIR, f"{name}.npy"))
    got = vecs[name]
    assert (got.dtype, got.shape) == (want.dtype, want.shape)
    np.testing.assert_array_equal(got, want)


def test_check_reproduces_every_sum(capsys):
    assert tv.check(tv.DATA_DIR, "cpu")
    assert "OK: all vectors reproduce" in capsys.readouterr().out


def test_check_fails_on_a_wrong_sum(tmp_path, capsys):
    d = tmp_path / "data"
    shutil.copytree(tv.DATA_DIR, d)
    sums = json.load(open(d / "checksums.json"))
    sums["lwe_ks"] = "0" * 64
    json.dump(sums, open(d / "checksums.json", "w"))
    assert not tv.check(str(d), "cpu")
    out = capsys.readouterr().out
    assert "MISMATCH lwe_ks" in out and "FAIL" in out


def test_generate_writes_the_golden_files(tmp_path):
    sums = tv.generate(str(tmp_path), "cpu")
    assert sums == json.load(open(os.path.join(tv.DATA_DIR,
                                               "checksums.json")))
    for name in NAMES:
        np.testing.assert_array_equal(
            np.load(tmp_path / f"{name}.npy"),
            np.load(os.path.join(tv.DATA_DIR, f"{name}.npy")))


def test_generate_refuses_the_golden_directory(tmp_path):
    link = tmp_path / "link"
    link.symlink_to(tv.DATA_DIR)
    for target in (tv.DATA_DIR, str(link)):
        with pytest.raises(ValueError, match="golden vectors"):
            tv.generate(target, "cpu")
    r = subprocess.run(
        [sys.executable, "-m", "tfhe_tpu_torch.apps.test_vectors",
         "generate"], cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert r.returncode != 0 and "generate outdir" in r.stderr


def test_command_line_check():
    r = subprocess.run(
        [sys.executable, "-m", "tfhe_tpu_torch.apps.test_vectors", "check",
         tv.DATA_DIR, "cpu"], cwd=ROOT, capture_output=True, text=True,
        timeout=300, env=dict(os.environ, OMP_NUM_THREADS="1"))
    assert r.returncode == 0, r.stderr[-2000:]
    assert "OK: all vectors reproduce" in r.stdout
