"""The deepest cases of ``test_torch_integer_extra.py``: ``scalar_div_rem``
by 3, by 8 and by 300 at PARAM_TEST_TOY, 4 blocks, bit-equal to
``tfhe_tpu.integer.ops_extra`` (same keys, same JAX encryptions carried
in, equal degrees and noise levels, the clear quotient and remainder back,
inputs untouched; tolerance 0). A file of their own, so that the
``--dist loadfile`` workers do not run them behind that file's cases."""

import pytest

from test_torch_integer_extra import DIV_CASES, ctx  # noqa: F401  (fixture)
from test_torch_integer_ops import (  # noqa: F401  (one_torch_thread: autouse)
    one_torch_thread, run_case)

@pytest.mark.parametrize("name", list(DIV_CASES))
def test_op_bit_equal(ctx, name):  # noqa: F811
    run_case(ctx, *DIV_CASES[name])
