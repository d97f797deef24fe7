"""The port's test utilities (`utils/testing.py`) against the JAX
package's: `compare_outputs`, `identity_qk_fixture` and `print_matrix`
given the same inputs reach the same verdict and print the same lines,
for numpy arrays and for torch tensors."""

import numpy as np
import pytest
import torch

from cuda_flashattention_tpu.utils import testing as jt
from cuda_flashattention_torch.utils import testing as tt


def _pair(seed, shape=(3, 5, 7)):
    rng = np.random.default_rng(seed)
    e = rng.uniform(-2, 2, shape).astype(np.float32)
    a = e + rng.normal(0, 1e-3, shape).astype(np.float32)
    a.flat[::17] += 0.5  # some misses
    return a, e


@pytest.mark.parametrize("kw", [dict(), dict(rtol=5e-3, atol=1e-3),
                                dict(rtol=1e-6, atol=1e-6, max_print=3),
                                dict(rtol=0.0, atol=10.0)])
@pytest.mark.parametrize("as_tensor", [False, True])
def test_compare_outputs_agrees(kw, as_tensor, capsys):
    a, e = _pair(0)
    want = jt.compare_outputs(a, e, name="x", **kw)
    want_out = capsys.readouterr().out
    if as_tensor:
        a, e = torch.from_numpy(a), torch.from_numpy(e)
    got = tt.compare_outputs(a, e, name="x", **kw)
    assert got == want
    assert capsys.readouterr().out == want_out


def test_compare_outputs_quiet_and_shapes(capsys):
    a, e = _pair(1)
    assert tt.compare_outputs(a, e, atol=1e-6, rtol=0, verbose=False) is False
    assert capsys.readouterr().out == ""
    with pytest.raises(ValueError, match="shape"):
        tt.compare_outputs(a, e[0])


@pytest.mark.parametrize("n,d", [(4, 4), (6, 4), (3, 8)])
def test_identity_qk_fixture_agrees(n, d):
    for x, y in zip(tt.identity_qk_fixture(n, d),
                    jt.identity_qk_fixture(n, d)):
        assert x.dtype == y.dtype and np.array_equal(x, y)


@pytest.mark.parametrize("shape", [(4, 4), (10, 12), (3, 2, 5), (9,)])
def test_print_matrix_agrees(shape, capsys):
    m = np.arange(np.prod(shape), dtype=np.float32).reshape(shape) / 7
    jt.print_matrix("m", m)
    want = capsys.readouterr().out
    tt.print_matrix("m", m)
    assert capsys.readouterr().out == want
    tt.print_matrix("m", torch.from_numpy(m))
    assert capsys.readouterr().out == want
