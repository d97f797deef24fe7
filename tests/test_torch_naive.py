"""The torch port's oracle (`ops/naive.py`) against the JAX package's:
segment ids on the forward and the backward, and the TF32 flags left as
the caller set them.

Plain jnp on one side, plain torch on the other, fp32, the same numpy
inputs; gate 1e-5 (both compute the same fp32 sums, in another order)."""

import numpy as np
import pytest
import torch

from cuda_flashattention_tpu.ops import naive as jnaive
from cuda_flashattention_torch.ops import naive as tnaive
from cuda_flashattention_torch.utils.testing import assert_close

GATE = 1e-5


def _inputs(seed=0, b=2, h=3, nq=12, nk=12, d=16):
    rng = np.random.default_rng(seed)
    q, k, v, do = (rng.standard_normal((b, h, n, d)).astype(np.float32)
                   for n in (nq, nk, nk, nq))
    # three packed segments per row of the batch; query row 0 of batch 1
    # has a segment of its own that no key carries (a row with no visible
    # key: O = 0, every gradient 0)
    qseg = np.repeat(np.array([[0] * 4 + [1] * 5 + [2] * 3]), b, 0)
    kseg = qseg.copy()
    qseg[1, 0] = 7
    return q, k, v, do, qseg.astype(np.int32), kseg.astype(np.int32)


@pytest.mark.parametrize("causal", [False, True])
def test_segment_ids_match_jax_oracle(causal):
    q, k, v, do, qseg, kseg = _inputs()
    seg = dict(q_segment_ids=qseg, kv_segment_ids=kseg)
    o_j, lse_j = jnaive.naive_attention(q, k, v, causal=causal, **seg)
    grads_j = jnaive.naive_attention_backward(q, k, v, do, causal=causal,
                                              **seg)
    t = [torch.from_numpy(x) for x in (q, k, v, do)]
    tseg = dict(q_segment_ids=torch.from_numpy(qseg),
                kv_segment_ids=torch.from_numpy(kseg))
    o_t, lse_t = tnaive.naive_attention(*t[:3], causal=causal, **tseg)
    grads_t = tnaive.naive_attention_backward(*t, causal=causal, **tseg)
    assert_close(o_t, o_j, GATE, "O")
    assert_close(lse_t, lse_j, GATE, "LSE")
    for name, g_t, g_j in zip(("dQ", "dK", "dV"), grads_t, grads_j):
        assert_close(g_t, g_j, GATE, name)
    # the masks are really in the path: the empty row is 0, and the
    # segments change O against the unmasked oracle
    assert float(o_t[1, :, 0].abs().max()) == 0.0
    assert float(grads_t[0][1, :, 0].abs().max()) == 0.0
    o_free, _ = tnaive.naive_attention(*t[:3], causal=causal)
    assert float((o_free - o_t).abs().max()) > 1e-2


def test_oracle_restores_tf32_flags():
    """Each call switches TF32 off for itself only, also when it raises."""
    q, k, v, do, _, _ = _inputs(nq=4, nk=4)
    t = [torch.from_numpy(x) for x in (q, k, v, do)]
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    try:
        for flags in ((True, True), (True, False), (False, True)):
            (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32) = flags
            tnaive.naive_attention(*t[:3], causal=True)
            tnaive.naive_attention_backward(*t, causal=True)
            with pytest.raises(RuntimeError):
                tnaive.naive_attention(t[0], t[1][..., :8], t[2])
            assert (torch.backends.cuda.matmul.allow_tf32,
                    torch.backends.cudnn.allow_tf32) == flags
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved
